"""Delta weight distribution: content-addressed checkpoints.

A checkpoint becomes a manifest (the atomic publish unit, a small JSON
file) plus content-addressed chunks in a write-once store, so publishing
epoch N+1 after epoch N moves only the chunks that changed. ``cas.py`` is
the format (store, chunk plan, manifest), ``publish.py`` the trainer's
side (``--publish delta``, chunk GC), ``fetch.py`` the server's (the
reload watcher's loader: fetch missing chunks from peers, then the
source; rebuild and quantize only dirty leaves). Counterpart of
``pytorch_distributed_mnist_tpu/distrib/``; each package reads what the
other writes.
"""
