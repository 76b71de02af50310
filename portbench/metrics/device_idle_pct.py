"""The card's idle share of the profiled sub-window: 100 x (1 - busy
seconds / the capture's seconds).  Nothing without a capture."""


def read(snap: dict):
    prof = snap.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
