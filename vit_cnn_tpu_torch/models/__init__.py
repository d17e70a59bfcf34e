"""Models of the port (PyTorch counterparts of vit_cnn_tpu.models)."""
