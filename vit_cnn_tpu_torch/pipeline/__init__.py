"""Training data pipeline (counterpart of vit_cnn_tpu.pipeline)."""
