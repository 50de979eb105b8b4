"""Profile the advance step of the bench-class deck on the GPU and print a
per-op and per-phase device-time breakdown, reduced from the
jax.profiler perfetto trace.

Per-phase attribution uses the step's jax.named_scope names
(``phase_sort``, ``phase_push``, ``phase_boundary``, ``phase_jf``,
``phase_field``, ``phase_interp``, ``phase_emit``).  GPU kernel events
carry only the kernel's name (fusions run inside CUDA graphs), so each
kernel is mapped to its scope through the ``op_name`` metadata of the
same-named instruction in the compiled HLO of the profiled executable.
The device's busy time is the union of its op intervals; idle share is
1 - busy / (first op start .. last op end).

Usage: python tools/profile_step.py [npart] [nx] [steps]
Env:   PROF_DIR (default <checkout>/.profile_out), PROF_NY, PROF_NZ,
       PROF_TAIL=1 (list the long tail op by op)
"""

import glob
import gzip
import json
import os
import re
import shutil
import sys
import time
from collections import defaultdict

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("sort", "interp", "push", "emit", "boundary", "jf", "field")
# envelope events that duplicate the leaf ops they contain
ENVELOPES = ("jit_", "while", "body", "cond", "region", "XlaModule")


def _load_trace(prof_dir):
    files = glob.glob(f"{prof_dir}/**/*.trace.json.gz", recursive=True)
    if not files:
        return None
    with gzip.open(sorted(files)[-1], "rt") as fh:
        return json.load(fh)["traceEvents"]


def _busy_ms(intervals):
    """Union length (ms) of [start, end) intervals in microseconds."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def hlo_phase_map(hlo_text):
    """{kernel name: phase} from compiled HLO text: an instruction's
    ``op_name`` metadata holds the jax.named_scope stack.  Kernel names
    in the trace spell the instruction's dots and dashes as '_'."""
    out = {}
    for line in hlo_text.splitlines():
        m = re.match(r'\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name="([^"]*)"',
                     line)
        if m:
            ph = re.search(r"phase_([a-z]+)", m.group(2))
            if ph:
                out[re.sub(r"[.\-]", "_", m.group(1))] = ph.group(1)
    return out


def _phase_of(name, meta, phase_map):
    for p in PHASES:
        if f"phase_{p}" in meta or f"phase_{p}" in name:
            return p
    base = re.sub(r"[.\-]", "_", name)
    if base in phase_map:
        return phase_map[base]
    # sort kernels are named after their HLO sort instruction plus a suffix
    stem = re.sub(r"(_\d+)+(__\d+)?$", "", base)
    hits = {v for k, v in phase_map.items() if k.startswith(stem + "_")
            or k == stem}
    return hits.pop() if len(hits) == 1 else "other"


def reduce_trace(events, steps, phase_map=None):
    """Per-thread, per-op and per-phase device time from perfetto
    events; ``phase_map`` maps kernel names to phases (hlo_phase_map)."""
    phase_map = phase_map or {}
    pname, tname = {}, {}
    for e in events:
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            pname[e["pid"]] = e.get("args", {}).get("name", "")
        elif e.get("name") == "thread_name":
            tname[(e["pid"], e.get("tid"))] = e.get("args", {}).get("name",
                                                                    "")
    dev_pids = {p for p, n in pname.items()
                if "/device:" in n and "CPU" not in n.upper()}
    per_thread = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in dev_pids:
            t = per_thread[(pname[e["pid"]],
                            tname.get((e["pid"], e.get("tid")), "?"))]
            t[0] += 1
            t[1] += e.get("dur", 0) / 1e3
    print("== device trace lines (process | thread: events, ms) ==")
    for (p, t), (n, ms) in sorted(per_thread.items()):
        print(f"  {p} | {t}: {n} events, {ms:.3f} ms")

    # leaf ops: the "XLA Ops" line when the trace has one, else every
    # stream line of the device
    names = {k: v for k, v in tname.items() if k[0] in dev_pids}
    op_tids = {k for k, v in names.items() if v == "XLA Ops"}
    if not op_tids:
        op_tids = {k for k, v in names.items()
                   if v.startswith("Stream") or "stream" in v.lower()}

    by_name, count, detail = defaultdict(float), defaultdict(int), {}
    by_phase = defaultdict(float)
    intervals = []
    for e in events:
        if e.get("ph") != "X" or (e.get("pid"), e.get("tid")) not in op_tids:
            continue
        name = e.get("name", "?")
        if name.startswith(ENVELOPES):
            continue
        dur = e.get("dur", 0) / 1e3
        by_name[name] += dur
        count[name] += 1
        intervals.append((e["ts"], e["ts"] + e.get("dur", 0)))
        args = e.get("args", {}) or {}
        meta = " ".join(str(v) for v in args.values())
        detail.setdefault(name, meta[:160])
        by_phase[_phase_of(name, meta, phase_map)] += dur
    total = sum(by_name.values())
    busy = _busy_ms(intervals)
    span = ((max(e for _, e in intervals) - min(s for s, _ in intervals))
            / 1e3 if intervals else 0.0)
    return dict(by_name=by_name, count=count, detail=detail,
                by_phase=by_phase, total=total,
                busy=busy, span=span)


def main():
    npart = int(sys.argv[1]) if len(sys.argv) > 1 else 4_000_000
    nx = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 6
    nz = int(os.environ.get("PROF_NZ", 1))
    ny = int(os.environ.get("PROF_NY", nx))
    prof_dir = os.environ.get("PROF_DIR", os.path.join(ROOT, ".profile_out"))

    from vpic_tpu.core.diagnostics import require_gpu

    dev = require_gpu()
    print(f"device: {dev['kind']} x{dev['count']} [{dev['nvidia_smi']}]")
    from __graft_entry__ import _build
    sim = _build(nx=nx, ny=ny, nz=nz, npart=npart // 2)
    k = sim.opts.resort_interval
    steps = max(k, (steps // k) * k)

    jax.block_until_ready(sim.advance(steps))       # compile + warm up
    t0 = time.perf_counter()
    jax.block_until_ready(sim.advance(steps))
    dt_plain = time.perf_counter() - t0
    total_np = sum(int(np.asarray(sp.np)) for sp in sim.state.species)
    print(f"== untraced: {dt_plain / steps * 1e3:.3f} ms/step, "
          f"{total_np * steps / dt_plain:.4e} pushes/s ({steps} steps) ==")

    shutil.rmtree(prof_dir, ignore_errors=True)
    with jax.profiler.trace(prof_dir, create_perfetto_trace=True):
        jax.block_until_ready(sim.advance(steps))

    events = _load_trace(prof_dir)
    if events is None:
        print("no trace found")
        return
    # the profiled executable: whole cycles run as one scanned dispatch
    m = steps // k
    fn = sim._cycles_scan(m) if m >= 2 else sim._advance_cycle
    hlo = fn.lower(sim.state).compile().as_text()
    r = reduce_trace(events, steps, hlo_phase_map(hlo))
    total = max(r["total"], 1e-9)
    print(f"\n== device busy {r['busy'] / steps:.3f} ms/step over a "
          f"{r['span'] / steps:.3f} ms/step op span: idle share "
          f"{1 - r['busy'] / max(r['span'], 1e-9):.4f} ==")
    print("\n== per-phase (named_scope of each kernel) ==")
    print(f"{'phase':>10} {'ms/step':>9} {'%':>6}")
    for p, ms in sorted(r["by_phase"].items(), key=lambda kv: -kv[1]):
        print(f"{p:>10} {ms / steps:9.3f} {100 * ms / total:6.1f}")

    rows = sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:40]
    print(f"\n{'ms_total':>9} {'ms/step':>8} {'n':>6}  name")
    for name, ms in rows:
        print(f"{ms:9.3f} {ms / steps:8.3f} {r['count'][name]:6d}  "
              f"{name[:60]}  {r['detail'].get(name, '')[:100]}")

    # the long tail by opcode family, so many small ops show up by name
    listed = {n for n, _ in rows}
    fam_ms, fam_n = defaultdict(float), defaultdict(int)
    for name, ms in r["by_name"].items():
        if name not in listed:
            fam = re.sub(r"[._\d]+$", "", name)
            fam_ms[fam] += ms
            fam_n[fam] += r["count"][name]
    print("\n== long tail by opcode family (ops not listed above) ==")
    for fam, ms in sorted(fam_ms.items(), key=lambda kv: -kv[1])[:20]:
        print(f"{ms:9.3f} {ms / steps:8.3f} {fam_n[fam]:6d}  {fam}")
    if os.environ.get("PROF_TAIL"):
        tail = [(n, m) for n, m in r["by_name"].items() if n not in listed]
        for name, ms in sorted(tail, key=lambda kv: -kv[1])[:40]:
            print(f"{ms:9.3f} {ms / steps:8.3f} {r['count'][name]:6d}  "
                  f"{name[:40]}  {r['detail'].get(name, '')[:140]}")
    print(f"sum over leaf op events: {r['total']:.3f} ms "
          f"({r['total'] / steps:.3f} ms/step)")


if __name__ == "__main__":
    main()
