"""Run supervision of the port: the agreed exit, the watchdogs and fault
points (``supervision.py``), elastic shrink and grow (``elastic.py``) and
the chaos harness (``chaos.py``)."""
