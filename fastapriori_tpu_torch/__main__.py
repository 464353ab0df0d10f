"""``python -m fastapriori_tpu_torch`` (counterpart:
fastapriori_tpu/__main__.py)."""

import sys

from fastapriori_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
