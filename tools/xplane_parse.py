"""Per-kernel device time and idle share from a JAX profiler trace (GPU).

On an NVIDIA GPU the trace has one plane per card, named /device:GPU:<n>.
Kernels run as events on its stream lines ("Stream #<id>(...)"); this
reduction sums their durations by kernel name, and takes the union of the
kernel intervals as the card's busy time over the traced window (first
kernel start to last kernel end), so idle share = 1 - busy / window.

Usage: python tools/xplane_parse.py <trace_dir_or_xplane.pb> [top_n]
"""
import glob
import os
import sys
from collections import defaultdict


def gpu_planes(profile):
    """The card planes of a jax.profiler.ProfileData."""
    return [p for p in profile.planes if p.name.startswith("/device:GPU:")]


def kernel_events(plane):
    """(name, start_ns, end_ns) of every kernel on the plane's streams."""
    return [
        (e.name, e.start_ns, e.end_ns)
        for line in plane.lines
        if line.name.startswith("Stream")
        for e in line.events
    ]


def busy_ns(intervals):
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(plane):
    """{'kernels': {name: [ms, count]}, 'busy_ms', 'window_ms', 'idle'}"""
    evs = kernel_events(plane)
    kernels = defaultdict(lambda: [0.0, 0])
    for name, s, e in evs:
        k = kernels[name]
        k[0] += (e - s) / 1e6
        k[1] += 1
    busy = busy_ns([(s, e) for _, s, e in evs]) / 1e6
    window = (max(e for _, _, e in evs) - min(s for _, s, _ in evs)) / 1e6 \
        if evs else 0.0
    return {
        "kernels": dict(kernels),
        "busy_ms": busy,
        "window_ms": window,
        "idle": 1.0 - busy / window if window > 0 else 0.0,
    }


def main():
    from jax.profiler import ProfileData

    path = sys.argv[1]
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 40
    if os.path.isdir(path):
        cands = glob.glob(f"{path}/**/*.xplane.pb", recursive=True)
        if not cands:
            sys.exit(f"no .xplane.pb under {path}")
        path = max(cands, key=os.path.getmtime)
    planes = gpu_planes(ProfileData.from_file(path))
    if not planes:
        sys.exit(f"{path}: no /device:GPU plane (not a GPU trace)")
    for plane in planes:
        s = summarize(plane)
        print(f"== {plane.name}: busy {s['busy_ms']:.3f} ms of "
              f"{s['window_ms']:.3f} ms, idle share {s['idle']:.3f}")
        top = sorted(s["kernels"].items(), key=lambda kv: -kv[1][0])
        for name, (ms, cnt) in top[:top_n]:
            print(f"  {ms:10.3f} ms  x{cnt:<6d} {name[:110]}")


if __name__ == "__main__":
    main()
