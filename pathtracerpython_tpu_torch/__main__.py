"""``python -m pathtracerpython_tpu_torch``: render an SDL scene (see
``cli/main.py``). Importing this module runs nothing."""

import sys

from pathtracerpython_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
