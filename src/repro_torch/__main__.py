"""``python -m repro_torch`` — dispatch to the characterization CLI."""
import sys

from repro_torch.api.cli import main

if __name__ == "__main__":
    sys.exit(main())
