"""Traffic generators, one module per ``kind`` a workload file names. Each
has ``schedule(params, seconds) -> dict``: ``{"open": offsets}`` (the
seconds after the window's start at which each request is due, ascending) or
``{"closed": callers}``.

An open schedule is one draw from the workload's ``shape_seed``, the same in
every run of the cell (a replayed trace): the run's ``--seed`` draws the
prompts and the weights, not the arrivals, so runs differ in their inputs
and not in their work."""
