"""Every acknowledged operation (PUT 204, GET 200) answered inside the
window, over the window's length (load generator's clock)."""


def read(snap: dict):
    return snap["window_ok"] / snap["window_s"]
