"""Full-scene inference and serving (counterparts of vit_cnn_tpu.infer)."""
