"""The benchmark of the PyTorch and CUDA port of the simulator (``mcray_tpu_torch``)."""
