"""``python -m vit_cnn_tpu_torch ...`` (one training run) or ``... --serve``"""

from .cli import main

if __name__ == "__main__":
    main()
