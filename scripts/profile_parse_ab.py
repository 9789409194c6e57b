"""Read the same torch.profiler runs two ways on the card and compare:
`key_averages` (how chip_smoke.py read its profiles before) and
chip_smoke's `kernel_table` (the profiler's raw events).

    python3 scripts/profile_parse_ab.py

The runs: granite-moe-3b-a800m at full width (bf16, chip_smoke's seeded
init), a full batch of 4 slots, 2 decode steps profiled with CPU and CUDA
activities under the LM module labels (as `lm_families_serve` profiles
its decode), then the same steps with CUDA activity alone (as `device_ms`
and `train_full` profile).  Each is read by `kernel_table` first, then by
`key_averages`, each timed; prints one JSON line a run: both seconds, the
kernels and calls each finds, the largest difference of a kernel's device
microseconds and of a label's, and whether the names and counts agree.
Exits 1 if they do not.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def key_averages_table(prof, labels=()) -> tuple:
    """The reading chip_smoke.py made before `kernel_table`."""
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    rows = {e.key: [e.self_device_time_total, e.count] for e in avgs
            if e.device_type == DeviceType.CUDA and e.key not in labels}
    by_label = {e.key: e.device_time_total for e in avgs
                if e.key in labels and e.device_type == DeviceType.CPU}
    return rows, by_label


def main() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    cs.import_port()
    torch = cs.torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    cs.phase_card()
    cfg = cs.get_config("granite-moe-3b-a800m")
    params = cs.lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = cs.serve_engine.ServeEngine(cfg, params, batch=4,
                                      s_max=cs.LM_FAMILIES_S_MAX,
                                      device="cuda")
    toks = torch.arange(cs.LM_FAMILIES_PROMPTS[1], device="cuda")[None] \
        % cfg.vocab_size
    cache = cs.lm.init_cache(cfg, 4, eng.s_max, per_slot=True, device="cuda")
    for b in range(4):
        _, cache = eng.prefill_slot(cache, toks, b)
    state = {"cache": cache,
             "cur": torch.zeros((4, 1), dtype=torch.int64, device="cuda")}

    def decode(n=cs.LM_PROFILE_STEPS):
        for _ in range(n):
            logits, state["cache"] = eng.decode(state["cache"], state["cur"])
            tok = cs.sampling.greedy(logits)
            tok.tolist()
            state["cur"] = tok[:, None]

    decode(2)
    labels = cs._labels(cs.LM_MODULES)
    ok = True
    for name, acts, lab in (
            ("labelled_decode", [ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], labels),
            ("cuda_only_decode", [ProfilerActivity.CUDA], ())):
        torch.cuda.synchronize()
        with cs._labelled_modules() if lab else cs.contextlib.nullcontext(), \
                profile(activities=acts) as prof:
            decode()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_rows, new_labels = cs.kernel_table(prof, lab)
        new_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        old_rows, old_labels = key_averages_table(prof, lab)
        old_s = time.perf_counter() - t0
        same = (sorted(new_rows) == sorted(old_rows) and all(
            new_rows[k][1] == old_rows[k][1] for k in old_rows)
            and sorted(new_labels) == sorted(old_labels))
        us = max((abs(new_rows[k][0] - old_rows[k][0]) for k in old_rows
                  if k in new_rows), default=0.0)
        lab_us = max((abs(new_labels[k] - old_labels[k]) for k in old_labels
                      if k in new_labels), default=0.0)
        ok &= same and us <= 1e-3 * max(1.0, max(
            r[0] for r in old_rows.values())) and lab_us <= 1e-3 * max(
            [1.0] + list(old_labels.values()))
        print(json.dumps(dict(
            run=name, kernel_table_s=new_s, key_averages_s=old_s,
            kernels=len(new_rows), calls=sum(r[1] for r in new_rows.values()),
            kernels_key_averages=len(old_rows),
            calls_key_averages=sum(r[1] for r in old_rows.values()),
            names_and_counts_agree=same, max_kernel_us_diff=us,
            labels=new_labels, labels_key_averages=old_labels,
            max_label_us_diff=lab_us)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
