"""Port parity: KV-block migration (``serving/migrate.py``, the engine's
``export_sequence`` / ``adopt_sequence`` / ``pool_fingerprint``) and
``DisaggregatedEngine`` against the JAX package on the CPU, at
``tiny(max_seq_len=64)`` in f32 with ``tests/test_migrate.py``'s
``ENGINE_KW``, on the same weights (flax init → ``params_from_jax``).

The wire format is byte-identical across the packages for f32, bf16 and
int8 payloads with the same fields; each package unpacks the other's
blob and reads what the other published in a ``FileKV`` directory. A
sequence exported by either engine is adopted and finished by the other
with the JAX monolithic stream. Streams, token ids and migration counts
are exact; exported f32 K/V rows match JAX's within 1e-5 (int8 codes
within one step, bf16 within one bf16 rounding of the row's largest).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.serving import DisaggregatedEngine as JDis
from distributed_tensorflow_tpu.serving import FileKV as JFileKV
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu.serving import Request as JRequest
from distributed_tensorflow_tpu.serving import migrate as jmig
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, params_from_jax)
from distributed_tensorflow_tpu_torch.serving import (
    DisaggregatedEngine, FileKV, InferenceEngine, OutOfBlocksError,
    Request, fetch_payload, pack_payload, payload_committed,
    publish_payload, unpack_payload)
from distributed_tensorflow_tpu_torch.serving import migrate as tmig

ROW_TOL = 1e-5
ENGINE_KW = dict(num_blocks=32, block_size=8, max_slots=4,
                 max_prompt_len=16)
# decode pools too small for the concurrency: preemption and rescue
PRESSURE_KW = dict(num_blocks=6, block_size=4, max_slots=4,
                   max_prompt_len=16)
KV_DTYPES = ("f32", "bf16", "int8")
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9, 8], [3, 1, 4, 1, 5]]
PRESSURE_PROMPTS = [[7, 7, 7], [8, 8, 8, 8], [9, 9], [1, 2, 3]]


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig.tiny(max_seq_len=64)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(max_seq_len=64)
    tparams = params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, tparams


def _engines(weights, **kw):
    jcfg, jparams, cfg, tparams = weights
    return (JEngine(jcfg, jparams, **kw),
            InferenceEngine(cfg, tparams, device="cpu", **kw))


def _prefill_one(engine, request_cls, tokens, rid="x", max_new=8, steps=1):
    engine.submit(request_cls(id=rid, tokens=tuple(tokens),
                              max_new_tokens=max_new))
    for _ in range(steps):
        engine.step()
    seq = next(s for s in engine.scheduler.running.values()
               if s.request.id == rid)
    assert seq.prefilled and not seq.done
    return seq


def _assert_clean(engine):
    acct = engine.block_accounting()
    assert acct["leaked_refs"] == 0 and acct["conserved"]


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """A JAX payload array (ml_dtypes bfloat16 included) as the torch
    tensor with the same bytes."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_payload(jp) -> tmig.MigrationPayload:
    """The port's payload with every field of the JAX payload ``jp``."""
    fields = {f.name: getattr(jp, f.name)
              for f in dataclasses.fields(jmig.MigrationPayload)}
    fields["arrays"] = {n: _to_torch(a) for n, a in jp.arrays.items()}
    return tmig.MigrationPayload(**fields)


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def _assert_rows_close(tarrays: dict, jarrays: dict, dt: str, written: int):
    """The rows both engines wrote (the first ``written``) within
    tolerance; the rest of the last block holds what each package's
    prefill leaves there (JAX's fixed-width prefill writes its padding)
    and is overwritten before it is read."""
    assert set(tarrays) == set(jarrays)
    for n, a in jarrays.items():
        got, want = tarrays[n], _to_torch(a)
        assert got.dtype == want.dtype and got.shape == want.shape
        got, want = got[:, :written], want[:, :written]
        if dt == "int8" and got.dtype == torch.int8:
            assert (got.int() - want.int()).abs().max() <= 1
            continue
        diff = (got.float() - want.float()).abs().max().item()
        if dt == "bf16":
            assert diff <= want.float().abs().max().item() * 2 ** -7
        else:
            assert diff <= ROW_TOL


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", KV_DTYPES)
def test_blob_byte_identical_across_packages(weights, dt):
    """The same payload fields pack to the same bytes in both packages;
    each package unpacks the other's blob bit for bit. The port's own
    export of the same prompt has the JAX export's fields, fingerprint
    and array shapes, and rows within tolerance."""
    jeng, teng = _engines(weights, kv_dtype=dt, **ENGINE_KW)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    jp = jeng.export_sequence(_prefill_one(jeng, JRequest, prompt, steps=3))
    tp = teng.export_sequence(_prefill_one(teng, Request, prompt, steps=3))
    if dt == "int8":
        assert "k_scale" in tp.arrays
    for f in ("request_id", "tokens", "max_new_tokens", "eos_id",
              "generated_prefix", "generated", "length", "fingerprint",
              "preemptions"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.nbytes == jp.nbytes and tp.n_blocks == jp.n_blocks
    _assert_rows_close(tp.arrays, jp.arrays, dt, tp.length - 1)

    same = _port_payload(jp)
    blob = jmig.pack_payload(jp)
    assert pack_payload(same) == blob
    back = unpack_payload(blob)
    assert set(back.arrays) == set(jp.arrays)
    for n, a in jp.arrays.items():
        assert back.arrays[n].shape == a.shape
        assert _bits(back.arrays[n]) == a.tobytes()
    jback = jmig.unpack_payload(pack_payload(tp))
    for n, t in tp.arrays.items():
        assert jback.arrays[n].dtype.name == str(t.dtype)[6:]
        assert jback.arrays[n].tobytes() == _bits(t)
    assert jback.request_id == tp.request_id and jback.length == tp.length


def test_filekv_directories_cross_packages(weights, tmp_path):
    """A blob one package publishes in a ``FileKV`` directory is fetched
    bit for bit by the other, in both directions."""
    jeng, teng = _engines(weights, kv_dtype="bf16", **ENGINE_KW)
    jp = jeng.export_sequence(_prefill_one(jeng, JRequest, [5, 3, 1, 2]))
    tp = teng.export_sequence(_prefill_one(teng, Request, [5, 3, 1, 2]))
    jmig.publish_payload(JFileKV(str(tmp_path)), "mig/j", jp)
    publish_payload(FileKV(str(tmp_path)), "mig/t", tp)
    assert payload_committed(FileKV(str(tmp_path)), "mig/j")
    assert jmig.payload_committed(JFileKV(str(tmp_path)), "mig/t")
    assert FileKV(str(tmp_path)).list("mig") == \
        JFileKV(str(tmp_path)).list("mig")
    got = fetch_payload(FileKV(str(tmp_path)), "mig/j", timeout_s=1.0)
    assert pack_payload(got) == jmig.pack_payload(jp)
    jgot = jmig.fetch_payload(JFileKV(str(tmp_path)), "mig/t",
                              timeout_s=1.0)
    assert jmig.pack_payload(jgot) == pack_payload(tp)


def test_trailing_bytes_rejected_and_torn_publish_never_committed(
        weights, tmp_path):
    _, teng = _engines(weights, **ENGINE_KW)
    payload = teng.export_sequence(_prefill_one(teng, Request, [1, 2, 3, 4]))
    blob = pack_payload(payload)
    with pytest.raises(ValueError, match="trailing"):
        unpack_payload(blob + b"\x00")
    with pytest.raises(ValueError, match="trailing"):
        jmig.unpack_payload(blob + b"\x00")
    agent = FileKV(str(tmp_path))
    # a torn publish: a chunk landed, the count key did not
    agent.key_value_set("mig/r1/c0", b"half a payload")
    assert not payload_committed(agent, "mig/r1")
    assert not jmig.payload_committed(JFileKV(str(tmp_path)), "mig/r1")
    with pytest.raises(TimeoutError):
        fetch_payload(agent, "mig/r1", timeout_s=0.05)
    publish_payload(agent, "mig/r1", payload)
    assert payload_committed(agent, "mig/r1")
    fetched = fetch_payload(agent, "mig/r1", timeout_s=1.0)
    assert _bits(fetched.arrays["k"]) == _bits(payload.arrays["k"])


@pytest.mark.parametrize("dt", KV_DTYPES)
def test_pool_fingerprint_equal_across_packages(weights, dt):
    jeng, teng = _engines(weights, kv_dtype=dt, **ENGINE_KW)
    assert teng.pool_fingerprint() == jeng.pool_fingerprint()
    assert teng.stats()["kv_dtype"] == jeng.stats()["kv_dtype"]


# ---------------------------------------------------------------------------
# export in one package, adopt in the other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_export_adopt_across_packages(weights, tmp_path, direction):
    """A live sequence exported and published by one package's engine is
    fetched and adopted by the other's, which finishes it with the JAX
    monolithic stream and no replayed token."""
    prompt = [2, 7, 1, 8, 2, 8]
    jmono, _ = _engines(weights, **ENGINE_KW)
    want = jmono.generate([prompt], max_new_tokens=8)[0]
    jeng, teng = _engines(weights, **ENGINE_KW)
    if direction == "jax_to_port":
        src, req, dst = jeng, JRequest, teng
        publish, fetch = jmig.publish_payload, fetch_payload
        agents = JFileKV(str(tmp_path)), FileKV(str(tmp_path))
    else:
        src, req, dst = teng, Request, jeng
        publish, fetch = publish_payload, jmig.fetch_payload
        agents = FileKV(str(tmp_path)), JFileKV(str(tmp_path))
    seq = _prefill_one(src, req, prompt, rid="d0", steps=3)
    assert 0 < len(seq.generated) < 8
    publish(agents[0], "drain/d0", src.export_sequence(seq, reason="drain"))
    _assert_clean(src)
    assert not src.scheduler.running
    payload = fetch(agents[1], "drain/d0", timeout_s=1.0)
    assert dst.can_adopt(payload)
    dst.adopt_sequence(payload)
    rec = dst.run_until_idle()["d0"]
    assert rec["tokens"] == want
    assert rec["replayed_tokens"] == 0
    assert (src.migrations_out, dst.migrations_in) == (1, 1)
    _assert_clean(dst)


# ---------------------------------------------------------------------------
# disaggregated against the JAX package
# ---------------------------------------------------------------------------

def _stats_counts(st: dict) -> dict:
    keys = ("migrations", "migrations_rescue", "migrated_bytes")
    # (the JAX engine's requests_completed and tokens_generated read
    # process-wide counters, so they are not compared)
    per = ("preemptions", "migrated_out", "migrations_out",
           "migrations_in", "migrated_bytes", "blocks_free", "steps")
    return {**{k: st[k] for k in keys},
            "replicas": [{k: r[k] for k in per}
                         for r in [st["prefill"]] + st["decode"]]}


@pytest.mark.parametrize("dt", KV_DTYPES)
def test_disaggregated_matches_jax(weights, dt):
    """Streams, migration counts and bytes equal the JAX disaggregated
    engine's per kv_dtype, every hop through the wire format; both equal
    the monolithic engine's streams; nothing leaks."""
    jcfg, jparams, cfg, tparams = weights
    want = JEngine(jcfg, jparams, kv_dtype=dt,
                   **ENGINE_KW).generate(PROMPTS, max_new_tokens=6)
    jdis = JDis(jcfg, jparams, num_decode=2, wire=True, kv_dtype=dt,
                **ENGINE_KW)
    tdis = DisaggregatedEngine(cfg, tparams, num_decode=2, wire=True,
                               kv_dtype=dt, device="cpu", **ENGINE_KW)
    assert jdis.generate(PROMPTS, max_new_tokens=6) == want
    assert tdis.generate(PROMPTS, max_new_tokens=6) == want
    assert _stats_counts(tdis.stats()) == _stats_counts(jdis.stats())
    assert [(m["id"], m["kind"], m["src"], m["dst"], m["blocks"])
            for m in tdis.migrations] == \
        [(m["id"], m["kind"], m["src"], m["dst"], m["blocks"])
         for m in jdis.migrations]
    st = tdis.stats()
    assert st["migrations"] == len(PROMPTS)
    assert 0 < st["migrate_p50_ms"] <= st["migrate_p99_ms"]
    acct = tdis.block_accounting()
    assert acct == jdis.block_accounting()
    assert acct["leaked_refs"] == 0 and acct["conserved"]


@pytest.mark.parametrize("case", ["rescue", "replay_only"])
def test_disaggregated_under_pressure_matches_jax(weights, case):
    """Decode pools too small for the concurrency: victims are rescued
    to a sibling with room (``rescue``: three decode replicas, so one
    usually has room), or replayed on their own replica
    (``replay_only``: rescue off); streams, rescues, preemptions and
    bytes equal the JAX engine's, and the streams equal the monolithic
    engine's."""
    jcfg, jparams, cfg, tparams = weights
    kw = dict(PRESSURE_KW, num_decode=3 if case == "rescue" else 2,
              rescue=case == "rescue", wire=True)
    want = JEngine(jcfg, jparams, **ENGINE_KW).generate(
        PRESSURE_PROMPTS, max_new_tokens=8)
    jdis = JDis(jcfg, jparams, **kw)
    tdis = DisaggregatedEngine(cfg, tparams, device="cpu", **kw)
    assert jdis.generate(PRESSURE_PROMPTS, max_new_tokens=8) == want
    assert tdis.generate(PRESSURE_PROMPTS, max_new_tokens=8) == want
    ts = tdis.stats()
    assert _stats_counts(ts) == _stats_counts(jdis.stats())
    preempted = sum(r["preemptions"] for r in ts["decode"])
    if case == "rescue":
        assert ts["migrations_rescue"] > 0
        assert ts["migrations_rescue"] == sum(
            e.scheduler.migrated_out for e in tdis.decoders)
    else:
        assert ts["migrations_rescue"] == 0 and preempted > 0
    acct = tdis.block_accounting()
    assert acct["leaked_refs"] == 0 and acct["conserved"]


# ---------------------------------------------------------------------------
# the engine's export/adopt contract (JAX tests/test_migrate.py:141-285)
# ---------------------------------------------------------------------------

def test_export_releases_source_and_adopt_continues(weights, tmp_path):
    jcfg, jparams, cfg, tparams = weights
    prompt = [2, 7, 1, 8, 2, 8]
    want = JEngine(jcfg, jparams, **ENGINE_KW).generate(
        [prompt], max_new_tokens=8)[0]
    a = InferenceEngine(cfg, tparams, device="cpu", **ENGINE_KW)
    b = InferenceEngine(cfg, tparams, device="cpu", **ENGINE_KW)
    seq = _prefill_one(a, Request, prompt, rid="d0", steps=3)
    payload = a.export_sequence(seq, reason="drain")
    assert not a.scheduler.running
    assert a.scheduler.allocator.num_free == a.cache_cfg.usable_blocks
    assert len(a.scheduler._free_slots) == a.max_slots
    _assert_clean(a)
    assert a.stats()["migrations_out"] == 1
    agent = FileKV(str(tmp_path))
    publish_payload(agent, "drain/d0", payload)
    b.adopt_sequence(fetch_payload(agent, "drain/d0", timeout_s=1.0))
    assert b.stats()["migrations_in"] == 1
    rec = b.run_until_idle()["d0"]
    assert rec["tokens"] == want and rec["replayed_tokens"] == 0
    _assert_clean(b)


def test_adopt_rejects_pool_fingerprint_mismatch(weights):
    _, _, cfg, tparams = weights
    a = InferenceEngine(cfg, tparams, device="cpu", kv_dtype="f32",
                        **ENGINE_KW)
    b = InferenceEngine(cfg, tparams, device="cpu", kv_dtype="int8",
                        **ENGINE_KW)
    payload = a.export_sequence(_prefill_one(a, Request, [1, 2, 3, 4]))
    free_before = b.scheduler.allocator.num_free
    slots_before = len(b.scheduler._free_slots)
    with pytest.raises(ValueError, match="fingerprint"):
        b.adopt_sequence(payload)
    assert b.scheduler.allocator.num_free == free_before
    assert len(b.scheduler._free_slots) == slots_before
    _assert_clean(b)


def test_can_adopt_probes_capacity_and_full_adopt_raises(weights):
    """As the JAX engine: ``can_adopt`` is false on a slot-exhausted
    engine, a forced adopt raises ``OutOfBlocksError`` and frees what it
    allocated, and the busy engine finishes its own requests with the
    JAX streams."""
    jcfg, jparams, cfg, tparams = weights
    want = JEngine(jcfg, jparams, **ENGINE_KW).generate(
        PROMPTS, max_new_tokens=6)
    a = InferenceEngine(cfg, tparams, device="cpu", **ENGINE_KW)
    b = InferenceEngine(cfg, tparams, device="cpu", **ENGINE_KW)
    payload = a.export_sequence(_prefill_one(a, Request, [6, 1, 6, 1]))
    for i, p in enumerate(PROMPTS):
        b.submit(Request(id=f"g{i}", tokens=tuple(p), max_new_tokens=6))
    b.step()
    assert not b.scheduler._free_slots
    assert not b.can_adopt(payload)
    free_before = b.scheduler.allocator.num_free
    with pytest.raises(OutOfBlocksError):
        b.adopt_sequence(payload)
    assert b.scheduler.allocator.num_free == free_before
    done = b.run_until_idle()
    assert [done[f"g{i}"]["tokens"] for i in range(len(PROMPTS))] == want
    assert b.can_adopt(payload)
    _assert_clean(b)


def test_prefill_role_builds_no_decode(weights):
    _, _, cfg, tparams = weights
    eng = InferenceEngine(cfg, tparams, device="cpu", role="prefill",
                          **ENGINE_KW)
    assert eng._decode is None
    eng.submit(Request(id="p", tokens=(1, 2, 3), max_new_tokens=4))
    eng.step()
    eng.step()
    (seq,) = eng.scheduler.running.values()
    assert seq.prefilled and len(seq.generated) == 1
    with pytest.raises(ValueError, match="role"):
        InferenceEngine(cfg, tparams, device="cpu", role="decode",
                        **ENGINE_KW)
