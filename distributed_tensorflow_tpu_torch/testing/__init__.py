"""Test infrastructure of the port: :mod:`multi_process_runner` (one
spawn process a task, and the persistent pool), :mod:`fleet_sim` (a
fleet of simulated workers as threads of one process under the real
recovery supervisor, and the data-service fleet) and :mod:`day_sim`
(a compressed production day over it) and :mod:`strategy_conformance`
(the Strategy-API contract suite). Modules and the main names load on
first use."""

from distributed_tensorflow_tpu_torch import lazy_names as _lazy_names

_M = "distributed_tensorflow_tpu_torch.testing."

#: package-level name -> the submodule that defines it
_LAZY = {
    "MultiProcessPoolRunner": _M + "multi_process_runner",
    **{n: _M + "fleet_sim" for n in (
        "FleetSim", "DataServiceSim", "DomainTopology")},
    "DaySim": _M + "day_sim",
    "StrategyConformance": _M + "strategy_conformance",
}
#: package-level module names
_LAZY_MODULES = {n: _M + n for n in (
    "multi_process_runner", "fleet_sim", "day_sim")}

__getattr__, __dir__ = _lazy_names(globals(), _LAZY, _LAZY_MODULES)
