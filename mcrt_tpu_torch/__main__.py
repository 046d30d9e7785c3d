"""`python -m mcrt_tpu_torch`: the CLI (see cli.py)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
