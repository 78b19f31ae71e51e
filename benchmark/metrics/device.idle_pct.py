"""device.idle_pct: share of the profiled control step's traced window in
which no kernel ran on the card."""


def read(run):
    prof = run.get("profile")
    if not prof or not prof["kernels"] or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
