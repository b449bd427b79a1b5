"""Serving of the port: the real-model frontend (:mod:`.backends`, torch
models behind ``HermesFrontend``) and the event-driven platform
(:mod:`.engine`, ``ServingCluster``)."""
