"""device.idle_share: the share of a call's time in which no operation
ran on the device (kernels, copies, fills), as the untraced loop runs:
1 - (the device-busy time a call, the union of the operations'
intervals in a ``torch.profiler`` trace of CUDA activity alone) / (the
time a call in the first window, which runs without the profiler).
Even with CUDA activity alone (``HOST_OPS = False``) the profiler adds
host time to every launch, which a share of the traced window would
count as idle; the device's own time a call it leaves as it is.  The
mean over the chips of a run."""

SPANS = []
AVERAGE = True
HOST_OPS = False


def read(view):
    tr = view.trace
    calls, seconds = view.untraced
    if tr is None or not tr.ops or view.calls < 1 or seconds <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / view.calls * calls / seconds)
