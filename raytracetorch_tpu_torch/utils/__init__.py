"""utils layer of the PyTorch port (mirrors raytracetorch_tpu/utils)."""
