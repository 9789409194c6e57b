"""Checkpoints of the port (`core.checkpoint`, `core.integrity`,
`StepProgram.load`, the launcher's `--ckpt-dir`) on the CPU.

* The port alone (ports of `tests/test_checkpoint_snn.py` and
  `tests/test_stream_connectivity.py::TestStreamedCheckpoint`): restart
  at the same layout, elastic restores H = 2 -> 1 / 3 / 4 and scatter,
  `latest`, the event restart, the event ring's exact order, event
  elastic restores, the delivery and connectivity-mode guards, streamed
  restores across shard count, placement and chunk size, and the
  integrity cases (a truncated file, a flipped bit, `latest_valid`
  falling back).
* Against the JAX package, for dense, event and streamed (2x2, H = 2):
  JAX saves at t = 30 and the port resumes to t = 60; the port saves and
  JAX resumes; both packages' files at t = 30 have equal members and
  `payload_sha256`; each continuation gives the raster and weight
  signatures of JAX's uninterrupted run.  JAX runs in one AVX-pinned
  subprocess (`tests/test_torch_reference.py::avx_env`), started once the
  port's files are written.
* Over ranks (gloo): an R = 2 job saves at t = 30, an R = 4 job restores
  and continues to t = 60, equal to JAX's uninterrupted H = 4 run.
* The launcher: two `--ckpt-dir` invocations of 30 steps write the file
  one invocation of 60 steps writes.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bench import subproc
from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                              checkpoint, observables)
from repro_torch.core import event_engine as EV

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import ROOT, avx_env  # noqa: E402

CFG_KW = dict(grid_x=2, grid_y=2, neurons_per_column=80,
              synapses_per_neuron=30, seed=13)
CFG = GridConfig(**CFG_KW)
T_SAVE, T_END = 30, 60
#: the modes held against the JAX package (EngineConfig keywords, H = 2)
MODES = {"dense": {}, "event": dict(delivery="event"),
         "streamed": dict(connectivity="streamed:chunk=1")}


def _sp(cfg=CFG, **eng):
    return StepProgram(cfg, EngineConfig(**eng), device="cpu")


def _sig(sp, raster) -> bytes:
    return observables.raster_signature(raster.numpy(), sp.plan.gid.numpy())


def _tail(sp, t0=0, t1=T_SAVE, steps=T_END - T_SAVE):
    """(state at t1, the uninterrupted raster signature of [t1, t1 +
    steps)), both from a run from the initial state."""
    s1, _, _ = sp.run(sp.init_state(), t0, t1 - t0)
    _, raster, _ = sp.run(sp.init_state(), t0, t1 - t0 + steps)
    return s1, _sig(sp, raster[t1 - t0:])


# -- the port alone ----------------------------------------------------------


def test_restart_bit_identical(tmp_path):
    """run(0..60) == run(0..30) + restart(30..60) on the same layout, and
    the loaded state is the saved one, tensor for tensor."""
    sp = _sp(n_shards=2)
    s30, want = _tail(sp)
    path = checkpoint.save(str(tmp_path / "ckpt_30.npz"), sp.spec, sp.plan,
                           s30, T_SAVE)
    state, t = sp.load(path)
    assert t == T_SAVE
    for a, b in zip(state, s30):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _, raster, _ = sp.run(state, t, T_END - T_SAVE)
    assert _sig(sp, raster) == want


@pytest.mark.parametrize("eng2", [
    dict(n_shards=1), dict(n_shards=4), dict(n_shards=3),
    dict(n_shards=4, placement="scatter")],
    ids=["h1", "h4", "h3", "h4_scatter"])
def test_elastic_reshard(tmp_path, eng2):
    """Saved at H = 2 block, restored at another layout: the same
    spikes."""
    sp = _sp(n_shards=2)
    s30, want = _tail(sp)
    path = checkpoint.save(str(tmp_path / "ckpt_30.npz"), sp.spec, sp.plan,
                           s30, T_SAVE)
    sp2 = _sp(**eng2)
    state, t = sp2.load(path)
    _, raster, _ = sp2.run(state, t, T_END - T_SAVE)
    assert t == T_SAVE and _sig(sp2, raster) == want


def test_latest_discovery(tmp_path):
    sp = _sp()
    assert checkpoint.latest(str(tmp_path)) is None
    for t in (5, 10):
        s, _, _ = sp.run(sp.init_state(), 0, t)
        checkpoint.save(str(tmp_path / f"ckpt_{t}.npz"), sp.spec, sp.plan,
                        s, t)
    assert checkpoint.latest(str(tmp_path)).endswith("ckpt_10.npz")
    assert checkpoint.saved_t(checkpoint.latest(str(tmp_path))) == 10


def test_event_restart_bit_identical(tmp_path):
    sp = _sp(n_shards=2, delivery="event")
    s30, want = _tail(sp)
    path = checkpoint.save(str(tmp_path / "ckpt_30.npz"), sp.spec, sp.plan,
                           s30, T_SAVE)
    state, t = sp.load(path)
    assert t == T_SAVE and isinstance(state, EV.EventState)
    _, raster, _ = sp.run(state, t, T_END - T_SAVE)
    assert _sig(sp, raster) == want


def test_event_ring_order_round_trips_exactly(tmp_path):
    """A same-layout restore rebuilds the ring lists in the EXACT live
    order (the arrivals add in list order), -1 after each list, and the
    continuation is the uninterrupted run's bit for bit."""
    cfg = GridConfig(grid_x=2, grid_y=2, neurons_per_column=120,
                     synapses_per_neuron=80, seed=13,
                     stim_events_per_ms_per_column=3)
    sp = _sp(cfg, n_shards=2, delivery="event")
    s30, _, _ = sp.run(sp.init_state(), 0, T_SAVE)
    assert int(s30.ev_count.sum()) > 0, "need pending events"
    path = checkpoint.save(str(tmp_path / "ckpt_30.npz"), sp.spec, sp.plan,
                           s30, T_SAVE)
    st, _ = sp.load(path)
    assert torch.equal(st.ev_ring, s30.ev_ring)
    assert torch.equal(st.ev_count, s30.ev_count)
    assert torch.equal(st.sat, s30.sat)
    _, r_cont, _ = sp.run(s30, T_SAVE, T_SAVE)
    _, r_rest, _ = sp.run(st, T_SAVE, T_SAVE)
    assert torch.equal(r_rest, r_cont)


@pytest.mark.parametrize("h2", [1, 4])
def test_event_elastic_reshard(tmp_path, h2):
    sp = _sp(n_shards=2, delivery="event")
    s30, want = _tail(sp)
    path = checkpoint.save(str(tmp_path / "ckpt_30.npz"), sp.spec, sp.plan,
                           s30, T_SAVE)
    sp2 = _sp(n_shards=h2, delivery="event")
    state, t = sp2.load(path)
    assert state.ev_ring.shape[-1] == sp2.cap_ev
    assert int(state.sat[1:].sum()) == 0       # the total lies on shard 0
    _, raster, _ = sp2.run(state, t, T_END - T_SAVE)
    assert _sig(sp2, raster) == want


def test_delivery_and_grid_guards(tmp_path):
    """A dense file refuses an event program and the other way round; a
    file of another grid or seed refuses to load; an event file needs
    cap_ev."""
    paths = {}
    for mode, kw in (("dense", {}), ("event", dict(delivery="event"))):
        sp = _sp(n_shards=2, **kw)
        s, _, _ = sp.run(sp.init_state(), 0, 10)
        paths[mode] = (sp, checkpoint.save(str(tmp_path / f"{mode}.npz"),
                                           sp.spec, sp.plan, s, 10))
    (spd, pd), (spe, pe) = paths["dense"], paths["event"]
    with pytest.raises(AssertionError, match="delivery mode mismatch"):
        spd.load(pe)
    with pytest.raises(AssertionError, match="delivery mode mismatch"):
        spe.load(pd)
    with pytest.raises(ValueError, match="cap_ev"):
        checkpoint.load(pe, spe.spec, spe.plan)
    other = _sp(GridConfig(**dict(CFG_KW, seed=14)), n_shards=2)
    with pytest.raises(AssertionError, match="seed mismatch"):
        other.load(pd)


class TestStreamedCheckpoint:
    STEPS = 10
    CFG = GridConfig(grid_x=2, grid_y=2, neurons_per_column=16,
                     synapses_per_neuron=10, seed=7)

    def test_elastic_restore_other_shards_and_chunk(self, tmp_path):
        """streamed save -> restore into another shard count AND
        placement AND chunk size -> the continuation is bit-exact (raster
        signature and every saved weight)."""
        sp1 = _sp(self.CFG, n_shards=2, connectivity="streamed:chunk=1")
        s1, _, _ = sp1.run(sp1.init_state(), 0, self.STEPS)
        p = checkpoint.save(str(tmp_path / "ckpt.npz"), sp1.spec, sp1.plan,
                            s1, self.STEPS)
        sref, rref, _ = sp1.run(s1, self.STEPS, self.STEPS)
        sp2 = _sp(self.CFG, n_shards=3, placement="scatter",
                  connectivity="streamed:chunk=2")
        s2, t0 = sp2.load(p)
        assert t0 == self.STEPS
        s2f, r2, _ = sp2.run(s2, t0, self.STEPS)
        assert _sig(sp2, r2) == _sig(sp1, rref)
        pa = checkpoint.save(str(tmp_path / "a.npz"), sp1.spec, sp1.plan,
                             sref, 2 * self.STEPS)
        pb = checkpoint.save(str(tmp_path / "b.npz"), sp2.spec, sp2.plan,
                             s2f, 2 * self.STEPS)
        za, zb = np.load(pa), np.load(pb)
        for k in ("tgt", "src", "j", "w", "last_arr", "arr_ring", "v"):
            np.testing.assert_array_equal(za[k], zb[k])
        assert str(za["payload_sha256"]) == str(zb["payload_sha256"])

    def test_cross_mode_load_refused_both_ways(self, tmp_path):
        sps = _sp(self.CFG, n_shards=2, connectivity="streamed:chunk=1")
        spm = _sp(self.CFG, n_shards=2)
        paths = []
        for sp in (sps, spm):
            s, _, _ = sp.run(sp.init_state(), 0, self.STEPS)
            paths.append(checkpoint.save(str(tmp_path / f"{len(paths)}.npz"),
                                         sp.spec, sp.plan, s, self.STEPS))
        with pytest.raises(AssertionError, match="connectivity mode"):
            spm.load(paths[0])
        with pytest.raises(AssertionError, match="connectivity mode"):
            sps.load(paths[1])


@pytest.fixture
def epochs(tmp_path):
    """Three valid epochs (t = 10, 20, 30) of a dense H = 1 run."""
    sp = _sp()
    s, t = sp.init_state(), 0
    for t1 in (10, 20, 30):
        s, _, _ = sp.run(s, t, t1 - t)
        t = t1
        checkpoint.save(str(tmp_path / f"ckpt_{t}.npz"), sp.spec, sp.plan,
                        s, t, raster_events=(np.arange(t), np.arange(t)))
    return sp, tmp_path


def test_a_truncated_checkpoint_raises(epochs):
    sp, d = epochs
    path = str(d / "ckpt_30.npz")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) * 2 // 3)
    with pytest.raises(checkpoint.CheckpointCorrupt) as e:
        sp.load(path)
    assert e.value.path == path
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.load_raster_events(path)


def test_a_flipped_bit_raises(epochs):
    """One bit of a stored weight flipped and the file re-zipped with the
    old digest: the digest catches it."""
    sp, d = epochs
    path = str(d / "ckpt_20.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    w = arrays["w"].copy()
    w.view(np.int32)[len(w) // 2] ^= 1
    arrays["w"] = w
    np.savez_compressed(path, **arrays)
    with pytest.raises(checkpoint.CheckpointCorrupt, match="sha256"):
        sp.load(path)


def test_latest_valid_falls_back_to_the_last_good_epoch(epochs):
    sp, d = epochs
    newest = str(d / "ckpt_30.npz")
    assert checkpoint.latest_valid(str(d)) == newest
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    assert checkpoint.latest(str(d)) == newest
    good = checkpoint.latest_valid(str(d))
    assert good == str(d / "ckpt_20.npz") and checkpoint.saved_t(good) == 20
    ev_t, ev_g = checkpoint.load_raster_events(good)
    assert ev_t.dtype == np.int64 and list(ev_g) == list(range(20))
    assert checkpoint.latest_valid(str(d / "none")) is None


# -- against the JAX package --------------------------------------------------


def _digest(path: str) -> str:
    with np.load(path) as z:
        return str(z["payload_sha256"])


def _members(path: str) -> dict:
    with np.load(path) as z:
        return {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                for k in z.files}


_RANK_CODE = """
import sys
sys.path.insert(0, {tests!r})
from repro_torch.cluster import runtime
runtime.ensure_initialized()
from test_torch_checkpoint import rank_ckpt
rank_ckpt({args!r})
"""


def rank_ckpt(args: dict) -> None:
    """Inside each rank: H = 4 dense block shards over the job.  "save"
    runs 0 -> T_SAVE and the primary saves the gathered state; "load"
    restores the file on every rank, places its block and runs to T_END;
    the primary reports the continuation's signatures."""
    from repro_torch.cluster import runtime
    from repro_torch.dist.mesh import make_snn_mesh
    sp = StepProgram(CFG, EngineConfig(n_shards=4), mesh=make_snn_mesh(4))
    if args["mode"] == "save":
        state, _, _ = sp.run(sp.place(sp.init_state()), 0, T_SAVE)
        full = sp.gather(state)
        if runtime.is_primary():
            checkpoint.save(args["path"], sp.spec, sp.plan, full, T_SAVE)
            subproc.emit(dict(world=runtime.process_count()))
        return
    state, t = sp.load(args["path"])
    state, raster, _ = sp.run(sp.place(state), t, T_END - t)
    raster, full = sp.gather_raster(raster), sp.gather(state)
    if runtime.is_primary():
        subproc.emit(dict(t=t, world=runtime.process_count(),
                          tail=_sig(sp, raster).hex(),
                          weights=sp.weight_signature(full).hex()))


def _ranks_job(tmp: Path, out: dict) -> None:
    """R = 2 saves, then R = 4 restores (in a thread, beside the JAX
    subprocess)."""
    tests = str(Path(__file__).resolve().parent)
    path = str(tmp / "ranks_30.npz")
    try:
        for mode, R in (("save", 2), ("load", 4)):
            code = _RANK_CODE.format(tests=tests,
                                     args=dict(mode=mode, path=path))
            out[mode] = subproc.results(subproc.run_ranks(
                code, R, device="cpu", timeout=300,
                store=str(tmp / f"store_{mode}")))
    except Exception as e:              # reported by the test
        out["error"] = e


@pytest.fixture(scope="module")
def interchange(tmp_path_factory):
    """The port's files at t = 30, then (at once) the JAX subprocess and
    the ranks' jobs; the port's resumes of the JAX package's files."""
    tmp = tmp_path_factory.mktemp("interchange")
    port = {}
    for mode, kw in MODES.items():
        sp = _sp(n_shards=2, **kw)
        s30, _, _ = sp.run(sp.init_state(), 0, T_SAVE)
        port[mode] = dict(sp=sp, path=checkpoint.save(
            str(tmp / f"port_{mode}.npz"), sp.spec, sp.plan, s30, T_SAVE))
    proc = subprocess.Popen([sys.executable, __file__, "--jax", str(tmp)],
                            env=avx_env(), cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    ranks = {}
    thread = threading.Thread(target=_ranks_job, args=(tmp, ranks))
    thread.start()
    try:
        out, err = proc.communicate(timeout=420)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        thread.join()
    assert proc.returncode == 0, err[-4000:]
    jax = json.loads(out.strip().splitlines()[-1])
    for mode, p in port.items():
        sp = p["sp"]
        state, t = sp.load(str(tmp / f"jax_{mode}.npz"))
        s60, raster, _ = sp.run(state, t, T_END - t)
        p.update(t=t, tail=_sig(sp, raster).hex(),
                 weights=sp.weight_signature(s60).hex())
    return dict(tmp=tmp, port=port, jax=jax, ranks=ranks)


@pytest.mark.parametrize("mode", list(MODES))
def test_a_jax_checkpoint_resumes_in_the_port(interchange, mode):
    got, want = interchange["port"][mode], interchange["jax"][mode]
    assert got["t"] == T_SAVE
    assert (got["tail"], got["weights"]) == (want["tail"], want["weights"])


@pytest.mark.parametrize("mode", list(MODES))
def test_a_port_checkpoint_resumes_in_jax(interchange, mode):
    want = interchange["jax"][mode]
    assert want["resumed_port"] == dict(t=T_SAVE, tail=want["tail"],
                                        weights=want["weights"])


@pytest.mark.parametrize("mode", list(MODES))
def test_both_packages_write_the_same_file(interchange, mode):
    """The same state at t = 30: equal members (names, dtypes, shapes,
    bytes) and equal digests."""
    tmp = interchange["tmp"]
    port, jax = (str(tmp / f"{pkg}_{mode}.npz") for pkg in ("port", "jax"))
    assert _members(port) == _members(jax)
    assert _digest(port) == _digest(jax) == interchange["jax"][mode][
        "digest"]
    with np.load(jax) as z:
        want = dict(streamed=np.int64).get(mode, np.int32)
        assert {z[k].dtype for k in ("tgt", "src", "j")} == {np.dtype(want)}
        assert z["gid"].dtype == np.int32
        assert z["arr_ring"].dtype == (np.int32 if mode == "event"
                                       else np.bool_)


def test_ranks_restore_across_rank_counts(interchange):
    """An R = 2 job's file restored by an R = 4 job (H = 4 both): the
    continuation is JAX's uninterrupted H = 4 run."""
    ranks = interchange["ranks"]
    assert "error" not in ranks, ranks.get("error")
    assert ranks["save"] == [dict(world=2)]
    got, want = ranks["load"][0], interchange["jax"]["dense_h4"]
    assert got == dict(t=T_SAVE, world=4, tail=want["tail"],
                       weights=want["weights"])


# -- the launcher -------------------------------------------------------------


LAUNCH = ["--grid", "2x2", "--neurons-per-column", "60", "--synapses", "20",
          "--shards", "2", "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--delivery", "event",
                                        "--exchange", "halo"]],
                         ids=["dense", "event"])
def test_the_launcher_resumes_where_it_stopped(tmp_path, capsys, extra):
    """`--ckpt-dir D` twice for 30 steps (in chunks of 10 the second
    time) writes the file one invocation of 60 steps writes."""
    from repro_torch.launch import snn
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    snn.main(LAUNCH + extra + ["--steps", "60", "--ckpt-dir", one])
    snn.main(LAUNCH + extra + ["--steps", "30", "--ckpt-dir", two])
    snn.main(LAUNCH + extra + ["--steps", "30", "--ckpt-dir", two,
                               "--ckpt-every", "10"])
    out = capsys.readouterr().out
    assert f"resumed at t=30 from {two}/ckpt_30.npz" in out
    assert out.count("done at t=60 ms") == 2
    assert [t for t, _ in checkpoint.integrity.checkpoint_steps(two)] == [
        30, 40, 50, 60]
    assert _digest(f"{one}/ckpt_60.npz") == _digest(f"{two}/ckpt_60.npz")
    with pytest.raises(SystemExit):
        snn.main(LAUNCH + ["--steps", "10", "--ckpt-every", "5"])


def _jax_main(tmp: str) -> dict:
    """Inside the AVX subprocess: for each mode at H = 2 the JAX package's
    uninterrupted run (the tail [30, 60) and the final weights), its file
    at t = 30 and its resume of the port's; and the dense H = 4 run."""
    import jax  # noqa: F401  (jax starts under the AVX flag)
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import StepProgram as JSP, checkpoint as jck
    from repro.core import observables as jobs

    def sig(sp, raster):
        return jobs.raster_signature(np.asarray(raster),
                                     np.asarray(sp.plan.gid)).hex()

    out = {}
    for mode, kw in dict(MODES, dense_h4={}).items():
        sp = JSP(JG(**CFG_KW), JE(n_shards=4 if mode == "dense_h4" else 2,
                                  **kw))
        s60, raster, _ = sp.run(sp.init_state(), 0, T_END)
        res = dict(tail=sig(sp, np.asarray(raster)[T_SAVE:]),
                   weights=sp.weight_signature(s60).hex())
        if mode in MODES:
            s30, _, _ = sp.run(sp.init_state(), 0, T_SAVE)
            path = jck.save(os.path.join(tmp, f"jax_{mode}.npz"), sp.spec,
                            sp.plan, s30, T_SAVE)
            res["digest"] = _digest(path)
            state, t = sp.load(os.path.join(tmp, f"port_{mode}.npz"))
            s, raster, _ = sp.run(state, t, T_END - t)
            res["resumed_port"] = dict(t=t, tail=sig(sp, raster),
                                       weights=sp.weight_signature(s).hex())
        out[mode] = res
    return out


if __name__ == "__main__":
    assert sys.argv[1] == "--jax"
    print(json.dumps(_jax_main(sys.argv[2])))
