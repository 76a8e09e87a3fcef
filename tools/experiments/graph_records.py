"""Where a short torch.profiler trace of replayed train-step graphs loses
kernel records.

    python3 tools/experiments/graph_records.py [--res 64] [--repeats 12] [--out FILE]

Builds the card tests' log step (tests/test_torch_cuda.g1_step: demo-box
at res^2, n = 2, albedo and emission trained), captures it at its first
call, then profiles its replays four ways:

- ``long``: one profile over LONG_REPLAYS steps, each followed by a
  synchronize and a MARGIN_S host sleep. Its replays give each graph's
  reference sequence of kernel names (the most common one).
- ``short``: the card test's pattern (tests/test_torch_cuda.py::
  test_profiled_graphed_steps): schedule(wait=0, warmup=1, active=2),
  three steps, each followed by a synchronize and prof.step().
- ``margins``: the same, with a MARGIN_S host sleep after each
  synchronize and after each prof.step(), so that no replay's kernels lie
  near the active window's start or end.
- ``after_render``: ``short``, each time after a profile of its own
  around an eager render of the scene (as the card tests profile renders
  before they profile replays in one process).

Each graph launch's device records are found by the correlation id of
its cudaGraphLaunch call. For each launch it prints the kernel records,
how many the reference has more, how far from the start and from the end
its sequence matches the reference's, the gap from the host's
cudaGraphLaunch call to the launch's first device record, from the
window's start (kineto's trace_start_ns) to that record, and from the
launch's last device record to the end of the profile's last event. One
JSON line a profile, then a summary.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

LONG_REPLAYS = 6
MARGIN_S = 0.02


def build(res: int, dev):
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.parallel import sharded
    from plutracer_tpu_torch.render.renderer import render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    s = compile_scene(load_scene_file(str(ROOT / "scenes" / "demo-box.urn"),
                                      ["/res", f"{res}x{res}"]), device=dev)
    target = render(s, res, res, 4, rng.PRNGKey(11)).reshape(-1, 3)
    params = dict(sharded.get_params(s))
    params["mat_color"] = params["mat_color"] * 0.5
    step = sharded.make_train_step(s, res, res, 2, loss_space="log",
                                   trainable=("mat_color", "light_intensity"))
    return step, params, target, s


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def launches_of(prof):
    """[(host start ns, [(start ns, end ns, name) of its device records])]
    for each cudaGraphLaunch of the profile, in host order, and the
    window's (start, end) ns."""
    events = list(prof.profiler.kineto_results.events())
    calls = sorted((e.start_ns(), e.correlation_id()) for e in events
                   if e.name() == "cudaGraphLaunch" and "CUDA" not in str(e.device_type()))
    by_corr = collections.defaultdict(list)
    for e in events:
        if "CUDA" in str(e.device_type()):
            by_corr[e.correlation_id()].append((e.start_ns(), e.end_ns(), e.name()))
    starts = [e.start_ns() for e in events]
    ends = [e.end_ns() for e in events]
    try:
        window = (prof.profiler.kineto_results.trace_start_ns(), max(ends))
    except AttributeError:
        window = (min(starts), max(ends))
    out = [(t, sorted(by_corr.get(c, []))) for t, c in calls]
    if calls and not any(recs for _, recs in out):
        # no correlation ids to follow: the kernels split at the largest gaps
        recs = sorted(r for rs in by_corr.values() for r in rs if is_kernel(r[2]))
        gaps = sorted(range(1, len(recs)), key=lambda i: recs[i][0] - recs[i - 1][1])
        cuts = [0, *sorted(gaps[len(gaps) - len(calls) + 1:]), len(recs)]
        out = [(t, recs[a:b]) for (t, _), a, b in zip(calls, cuts, cuts[1:])]
        print("graph_records: no correlation ids on the device records; split at gaps",
              file=sys.stderr)
    return out, window


def compare(names, ref):
    """(records the reference has more, matching prefix, matching suffix)."""
    pre = 0
    while pre < min(len(names), len(ref)) and names[pre] == ref[pre]:
        pre += 1
    suf = 0
    while suf < min(len(names), len(ref)) - pre and names[-1 - suf] == ref[-1 - suf]:
        suf += 1
    return len(ref) - len(names), pre, suf


def profiled_render(scene, res: int) -> None:
    """An eager render of `scene` under a profile of its own."""
    from torch.profiler import ProfilerActivity, profile

    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.render.renderer import render

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        render(scene, res, res, 2, rng.PRNGKey(9))
        torch.cuda.synchronize()


def profile_steps(step, p, st, target, start, pattern):
    """Three (short, margins, after_render) or LONG_REPLAYS (long) replayed
    steps under the profiler; returns (profile, params, state)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from plutracer_tpu_torch import rng

    key = rng.PRNGKey(6)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if pattern == "long":
        with profile(activities=acts) as prof:
            time.sleep(MARGIN_S)
            for i in range(LONG_REPLAYS):
                p, st, _ = step(p, st, target, rng.fold_in(key, start + i), (start + i) % 4)
                torch.cuda.synchronize()
                time.sleep(MARGIN_S)
        return prof, p, st
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=2, repeat=1)) as prof:
        for i in range(3):
            p, st, _ = step(p, st, target, rng.fold_in(key, start + i), (start + i) % 4)
            torch.cuda.synchronize()
            if pattern == "margins":
                time.sleep(MARGIN_S)
            prof.step()
            if pattern == "margins":
                time.sleep(MARGIN_S)
    return prof, p, st


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=12)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    out = open(args.out, "w") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")

    from plutracer_tpu_torch import rng

    step, p, target, scene = build(args.res, dev)
    st = step.init(p)
    p, st, _ = step(p, st, target, rng.PRNGKey(5), 0)  # the capture
    torch.cuda.synchronize()
    prof, p, st = profile_steps(step, p, st, target, 1, "long")
    launched, _ = launches_of(prof)
    seqs = [[n for _, _, n in recs if is_kernel(n)] for _, recs in launched]
    # the graphs alternate: forward, rest
    ref = []
    for g in (0, 1):
        common = collections.Counter(tuple(s) for s in seqs[g::2]).most_common()
        ref.append(list(common[0][0]))
        emit({"pattern": "long", "graph": ("forward", "rest")[g],
              "kernels_by_replay": [len(s) for s in seqs[g::2]],
              "distinct_sequences": len(common)})
    summary = collections.defaultdict(lambda: {"profiles": 0, "lossy": 0, "missing": []})
    start = 1 + LONG_REPLAYS
    for pattern in ("short", "margins", "after_render"):
        for r in range(args.repeats):
            if pattern == "after_render":
                profiled_render(scene, args.res)
            prof, p, st = profile_steps(step, p, st, target, start, pattern)
            start += 3
            launched, (w0, w1) = launches_of(prof)
            rows = []
            for j, (host, recs) in enumerate(launched):
                names = [n for _, _, n in recs if is_kernel(n)]
                more, pre, suf = compare(names, ref[j % 2])
                first = recs[0][0] if recs else None
                last = recs[-1][1] if recs else None
                rows.append({"graph": ("forward", "rest")[j % 2], "kernels": len(names),
                             "missing": more, "prefix": pre, "suffix": suf,
                             "first_after_call_us": (first - host) / 1e3 if recs else None,
                             "first_after_window_us": (first - w0) / 1e3 if recs else None,
                             "last_before_window_end_us": (w1 - last) / 1e3 if recs else None})
            missing = sum(r_["missing"] for r_ in rows)
            s = summary[pattern]
            s["profiles"] += 1
            s["lossy"] += int(missing != 0)
            s["missing"].append(missing)
            emit({"pattern": pattern, "repeat": r, "graph_launches": len(rows), "missing": missing,
                  "launches": rows})
    emit({"summary": dict(summary), "reference_kernels": [len(x) for x in ref],
          "card": torch.cuda.get_device_name(0), "torch": torch.__version__})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
