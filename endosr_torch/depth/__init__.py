"""The monodepth2 sub-project of the port: depth maps for the SR datasets."""
