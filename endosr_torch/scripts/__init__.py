"""The data scripts of the port (counterpart of the repository's
``scripts/``), each run as ``python -m endosr_torch.scripts.<name>`` with
the JAX script's arguments: ``kernel_visual``, ``generate_mod_LR_bic``,
``back_projection``, ``color2gray``, ``extract_subimgs_single``,
``create_lmdb``, ``export_gt_depth``, ``read_depth_map``,
``show_depthmask`` and ``transfer_params``. Each module's function does
the work (the tests call it); ``main(argv)`` parses the arguments. They
run on the host (numpy, ``cv2``), but ``kernel_visual``, whose kernel
comes from ``ops/degradation.py`` on the CPU."""
