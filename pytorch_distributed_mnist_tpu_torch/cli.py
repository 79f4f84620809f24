"""Command-line entry of the port.

``python -m pytorch_distributed_mnist_tpu_torch serve ...`` boots the
HTTP inference server (``serve/server.py``). Training, the JAX package's
default subcommand, is not ported yet: any other subcommand exits 2.
"""

from __future__ import annotations

import sys
from typing import Optional

NOT_PORTED = ("training is not ported yet: the PyTorch port serves only "
              "(python -m pytorch_distributed_mnist_tpu_torch serve ...)")


def main(argv: Optional[list] = None) -> None:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from pytorch_distributed_mnist_tpu_torch.serve.server import (
            main as serve_main,
        )

        serve_main(argv[1:])
        return
    print(NOT_PORTED, file=sys.stderr)
    raise SystemExit(2)
