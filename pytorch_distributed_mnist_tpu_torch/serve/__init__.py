"""Serving subsystem of the port: models on one device, on mesh groups or
on chains of stage devices, behind HTTP.

``SERVE_MODES`` and ``SERVE_PRECISIONS`` (``serve/programs.py``'s
import-time snapshots of its registries) are exported as the reference's
package exports them. They load on first access: ``serve/router.py``
runs under ``route`` without torch or numpy, and importing this package
must not pull them in.
"""

__all__ = ["SERVE_MODES", "SERVE_PRECISIONS"]


def __getattr__(name: str):
    if name in __all__:
        from pytorch_distributed_mnist_tpu_torch.serve import programs

        return getattr(programs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
