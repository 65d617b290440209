"""``replay_host_wait_us``: device idle a replayed tick of the profiled
call that waits for the host's launch. For each replay j >= 1, the idle
from the end of replay j-1's last device operation to the start of replay
j's first, the part of it before replay j's ``cudaGraphLaunch`` on the
host (the ``tick.replays`` spans' launch times, placed on the profiler's
clock by the ``obs.clock`` instant, matched in order to ``devtrace``'s
replays); the mean over those replays, in us. Silent when the counts
differ."""


def read(run):
    red = run.record.get("devtrace")
    events = run.record.get("events", [])
    clocks = [e["args"]["offset_ns"] for e in events
              if e.get("name") == "obs.clock"]
    if not red or not clocks:
        return None
    offset = clocks[-1]
    lo, hi = red["window"]
    launches = []
    for e in events:
        if e.get("name") == "tick.replays" and e.get("ph") == "X":
            base = e["ts"] * 1000 + offset
            if lo <= base <= hi:
                launches += [base + x for x in e["args"].get("launch_ns", [])]
    kernels, replays = red["kernels"], red["replays"]
    if len(replays) < 2 or len(launches) != len(replays):
        return None
    launches.sort()
    wait = 0
    for j in range(1, len(replays)):
        end = max(kernels[i][2] for i in replays[j - 1])
        start = kernels[replays[j][0]][1]
        wait += max(0, min(launches[j], start) - end)
    return wait / (len(replays) - 1) / 1e3
