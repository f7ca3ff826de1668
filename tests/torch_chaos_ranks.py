"""Rank function of ``tests/test_torch_chaos.py``'s cross-process
scenario (torch and the port only), importable by name in a spawned
rank."""

import time


def chaos_preemption_worker(tmpdir, seed):
    """Cross-process preemption via the chaos layer: the synthetic
    notice lands ONLY on process 0 (tagged rule); both processes must
    agree and commit one checkpoint at the same step."""
    import torch

    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        Checkpoint as Ckpt, CheckpointManager as Mgr)
    from distributed_tensorflow_tpu_torch.checkpoint.failure_handling \
        import PreemptionCheckpointHandler as Handler, \
        TerminationConfig as Cfg
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.resilience import faults as flt
    runtime = bootstrap.initialize(device="cpu")
    flt.install(flt.FaultSchedule(seed=seed, rules=[
        flt.FaultRule(site="preemption.signal", action="signal",
                      tag="0", hits=(5,))]))
    try:
        state = {"w": torch.zeros(())}

        def train_step():
            state["w"] = state["w"] + 1.0

        ckpt = Ckpt(w=state["w"])
        mgr = Mgr(ckpt, tmpdir, checkpoint_name="chaos")
        handler = Handler(mgr, Cfg(exit_fn=lambda: None))
        saved_at = None
        for _ in range(100):
            ckpt._objects["w"] = state["w"]
            handler.run(train_step)
            if handler._exited:
                saved_at = handler.total_run_calls
                break
            time.sleep(0.05)
        diag = (flt.active(), flt.events(), handler._step,
                handler._received.is_set())
        bootstrap.shutdown()
        return runtime.process_id, saved_at, diag
    finally:
        flt.clear()
