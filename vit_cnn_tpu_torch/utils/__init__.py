"""Seeding, palettes, artifacts and profiling (counterpart of
vit_cnn_tpu.utils)."""
