"""Cluster bootstrap and mesh construction on ``torch.distributed``:
:mod:`bootstrap` (the default process group from the launcher's
environment) and :mod:`topology` (named ``DeviceMesh`` dims, the data
axes). Import the submodule you use."""
