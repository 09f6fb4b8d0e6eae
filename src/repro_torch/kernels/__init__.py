"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

  ``color_step``     one color step of the SN-Train sweep (replaces the
                     Pallas ``_color_step_kernel``);
  ``knn_fuse``       kNN-fusion serving, select + evaluate (replaces the
                     Pallas ``_knn_fuse_kernel``);
  ``kernel_matvec``  the fused RBF kernel matvec (replaces the Pallas
                     ``_batched_kernel`` and ``_kernel``);
  ``ssd_intra``      the Mamba2 SSD intra-chunk term (replaces the Pallas
                     ``ssd_intra._kernel``);
  ``gram``           the tiled RBF Gram matrix (replaces the Pallas
                     ``gram._kernel``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each module counts its launches in
``launches``.
"""
