"""``python -m pytorch_distributed_mnist_tpu_torch`` — see ``cli.py``.

``route`` is dispatched here, before ``cli.py`` is imported: the fleet
router (``serve/router.py``) is pure stdlib and shares no fate with the
data plane it fronts, so its process never imports torch or numpy.
"""

import sys

if __name__ == "__main__":
    if sys.argv[1:2] == ["route"]:
        from pytorch_distributed_mnist_tpu_torch.serve.router import main

        main(sys.argv[2:])
    else:
        from pytorch_distributed_mnist_tpu_torch.cli import main

        main()
