"""Supervised training (counterpart of vit_cnn_tpu.train)."""
