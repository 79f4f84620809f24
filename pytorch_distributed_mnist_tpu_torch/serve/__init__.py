"""Serving subsystem of the port: one model on one device behind HTTP."""
