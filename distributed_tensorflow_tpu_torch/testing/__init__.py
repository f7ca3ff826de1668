"""Test infrastructure: :mod:`multi_process_runner` spawns one process a
rank. Import the submodule you use."""
