#!/usr/bin/env python
"""Per-stage device times of the tokenizer at the full dispatch geometry.

    python tools/measure/device_stages.py [--out DIR]

Runs one dispatch of 512 lanes x 2048 bytes (about 1 MiB of seeded text,
the same generator as chip_smoke.py) through ``DeviceTokenizer`` and
prints, for the card it runs on:

  - cold and warm compile time of the dispatch (warm = a fresh in-process
    cache over JAX's persistent compilation cache);
  - ``compiled.memory_analysis()`` and ``peak_bytes_in_use``;
  - device time per dispatch (enqueue N, ``block_until_ready``);
  - a profiler trace of a few full ``tokenize_staged`` calls, reduced to
    device time per named scope (match, decide, follow, stitch, concat,
    plus the metadata fetch and anything unlabelled) and the device's
    idle share over the traced window.

Exactness: the ids of the traced calls equal the native tokenizer's.
Needs a GPU; ``--allow-cpu`` runs the same steps on the CPU as a rehearsal
whose times are not device measurements.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

SCOPES = ("match", "decide", "follow", "stitch", "concat")
REPS = 20   # dispatches enqueued back to back for the device time


def op_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> named scope, from the op_name metadata of
    the optimized module."""
    out = {}
    pat = re.compile(r'%([\w.\-]+) = .*?op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.search(line)
        if not m:
            continue
        parts = m.group(2).split("/")
        out[m.group(1)] = next((p for p in parts if p in SCOPES), "other")
    return out


def reduce_trace(trace_dir: str, scopes_by_module: dict):
    """Device time per scope and the idle share of the device over the
    span of the host annotation named ``window``."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    pd = ProfileData.from_file(path)
    per_scope, intervals, window = {}, [], None
    for plane in pd.planes:
        is_device = plane.name.startswith("/device:")
        for line in plane.lines:
            for ev in line.events:
                if ev.name == "window" and not is_device:
                    window = (ev.start_ns, ev.end_ns)
                if not is_device:
                    continue
                stats = dict(ev.stats) if ev.stats else {}
                op = stats.get("hlo_op")
                mod = str(stats.get("hlo_module", ""))
                if op == "command_buffer":
                    # kernels replayed from a CUDA graph carry the graph's
                    # op; the kernel name is the fusion's, "." -> "_"
                    op = re.sub(r"_(\d+)$", r".\1", ev.name)
                if op is None:
                    if "memcpy" in ev.name.lower():
                        scope = "memcpy"
                    else:
                        continue
                elif "concat" in mod:
                    scope = "concat"
                elif "meta" in mod:
                    scope = "meta"
                else:
                    scope = scopes_by_module.get(mod, {}).get(str(op),
                                                              "other")
                per_scope[scope] = per_scope.get(scope, 0) + ev.duration_ns
                intervals.append((ev.start_ns, ev.end_ns))
    busy = 0
    if window is not None:
        lo, hi = window
        cur_s = cur_e = None
        for s, e in sorted(intervals):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
    span = (window[1] - window[0]) if window else 0
    return per_scope, busy, span


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "device_stages"))
    ap.add_argument("--allow-cpu", action="store_true",
                    help="rehearse on the CPU (times are not device times)")
    args = ap.parse_args(argv)

    import jax

    import chip_smoke
    from tokenmonster_tpu.core.vocab import Vocab
    from tokenmonster_tpu.native import NativeVocab
    from tokenmonster_tpu.ops.scan import MAX_LANES, DeviceTokenizer
    from tokenmonster_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.allow_cpu:
        raise SystemExit("device_stages: no GPU found")
    cache = enable_compile_cache()
    card = (chip_smoke.card_line() if dev.platform == "gpu"
            else "cpu rehearsal, not a device measurement")
    print(f"device {dev.platform} {dev.device_kind}; card {card}; "
          f"compile cache {cache}", flush=True)

    core = Vocab.load(chip_smoke.VOCAB_32K)
    t0 = time.perf_counter()
    tk = DeviceTokenizer(core)
    jax.block_until_ready(tk.tables())
    print(f"tables built and uploaded in {time.perf_counter() - t0:.3f} s",
          flush=True)
    chunk = tk.chunk
    text = core.normalize(chip_smoke.make_corpus(
        core, MAX_LANES * chunk, seed=99))[:MAX_LANES * chunk - 4096]
    staged = tk.stage(text)
    n, lanes, bufs = staged
    assert lanes == MAX_LANES and len(bufs) == 1, (lanes, len(bufs))
    buf, n_slice, last_lane = bufs[0]
    args_d = (buf, np.int32(n_slice), np.int32(0), np.int32(last_lane),
              np.bool_(True)) + tk.tables()

    fn = tk._fused_stitch_fn(lanes)
    t0 = time.perf_counter()
    compiled = fn.lower(*args_d).compile()
    cold = time.perf_counter() - t0
    jax.clear_caches()
    tk._fused.clear()
    tk._fused_stitch.clear()
    fn = tk._fused_stitch_fn(lanes)
    t0 = time.perf_counter()
    compiled = fn.lower(*args_d).compile()
    warm = time.perf_counter() - t0
    print(f"compile of one {lanes}-lane dispatch: cold {cold:.3f} s, "
          f"warm {warm:.3f} s", flush=True)
    print(f"memory_analysis: {compiled.memory_analysis()}", flush=True)

    jax.block_until_ready(compiled(*args_d))
    t0 = time.perf_counter()
    outs = [compiled(*args_d) for _ in range(REPS)]
    jax.block_until_ready(outs)
    per = (time.perf_counter() - t0) / REPS
    print(f"device time per dispatch: {per * 1e3:.3f} ms for {n_slice} "
          f"bytes ({n_slice / per / 1e6:.2f} MB/s), {REPS} enqueued, "
          f"block_until_ready", flush=True)

    res = tk.tokenize_staged(staged)          # compiles meta/concat too
    want, _missing = NativeVocab(core).tokenize(text)
    assert res is not None and np.array_equal(res[0], want), \
        "device ids differ from native"
    print(f"exact: {len(want)} ids == native ids (window {tk.last_mode})",
          flush=True)

    hlo = compiled.as_text()
    module_scopes = {"jit_run": op_scopes(hlo)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "dispatch.hlo.txt"), "w") as f:
        f.write(hlo)
    trace_dir = os.path.join(args.out, "trace")
    jax.profiler.start_trace(trace_dir)
    with jax.profiler.TraceAnnotation("window"):
        for _ in range(3):
            tk.tokenize_staged(staged)
    jax.profiler.stop_trace()
    per_scope, busy, span = reduce_trace(trace_dir, module_scopes)
    total = sum(per_scope.values())
    print("per-stage device ms per tokenize_staged call (3 traced): "
          + ", ".join(f"{k} {v / 3e6:.3f}"
                      for k, v in sorted(per_scope.items(),
                                         key=lambda kv: -kv[1])),
          flush=True)
    if span:
        print(f"traced window {span / 3e6:.3f} ms per call; device busy "
              f"{busy / 3e6:.3f} ms; idle share {1 - busy / span:.3f}; "
              f"kernel time sum {total / 3e6:.3f} ms", flush=True)
    stats = dev.memory_stats() or {}
    print(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}", flush=True)


if __name__ == "__main__":
    main()
