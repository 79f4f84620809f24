"""Data parallelism over processes: the rendezvous, the 1-D data axis,
the collectives and the local spawner (one device per process)."""
