"""Input pipelines of the port: :mod:`stream`, the append-only event log
the online trainer consumes. Import the submodule you use."""
