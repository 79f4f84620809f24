"""``python -m pytorch_distributed_mnist_tpu_torch`` — see ``cli.py``."""

from pytorch_distributed_mnist_tpu_torch.cli import main

if __name__ == "__main__":
    main()
