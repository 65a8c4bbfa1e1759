"""The monodepth2 sub-project of the port: the self-supervised depth
trainer (poses, view synthesis, the endovis and KITTI loaders, evaluation)
and the depth maps it gives the SR datasets."""
