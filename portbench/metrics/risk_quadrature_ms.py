"""Risk stack: device time of the program's `risk.costs.trajectory_risks`
(collision-probability quadrature and harm) per request, by CUDA events
around an eager call on each traced request's own rollout and predictions,
after the window, one warm-up call first; the mean over those requests."""
from __future__ import annotations

MAX_REQUESTS = 5


def read(run):
    import torch

    from frenetix_tpu_torch.risk.costs import trajectory_risks

    if not run.traced:
        return None
    times = []
    for prepared in run.traced[:MAX_REQUESTS]:
        args = run.entry.risk_inputs(prepared)
        if args is None:
            return None
        trajectory_risks(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trajectory_risks(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sum(times) / len(times)
