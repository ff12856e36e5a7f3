"""``python -m repro_torch.gateway`` — see :mod:`repro_torch.gateway.server`."""
import sys

from .server import main

if __name__ == "__main__":
    sys.exit(main())
