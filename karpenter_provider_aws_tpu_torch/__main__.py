"""`python -m karpenter_provider_aws_tpu_torch` → the controller CLI."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
