"""Entry point for ``python -m repro_torch.fleet``."""

import sys

from repro_torch.fleet.cli import main

if __name__ == "__main__":
    sys.exit(main())
