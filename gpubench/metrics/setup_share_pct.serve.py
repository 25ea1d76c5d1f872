"""Each request's own set-up (``amortized_infer``'s ``timing["setup_s"]``: masks,
Poisson draws, init stack, model build, restore) summed over the window's
requests, over the window's seconds, %."""


def read(run):
    if run.kind != "serve":
        return None
    return 100.0 * sum(run.window["setup_s"]) / run.net_seconds
