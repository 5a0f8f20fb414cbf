"""``python -m cilium_tpu_torch.analysis`` — the port's lint entry
point."""

import sys

from cilium_tpu_torch.analysis import run_cli

if __name__ == "__main__":
    sys.exit(run_cli())
