"""Rank bodies for the port's multi-process tests
(``test_torch_port_multihost.py``); this module holds no tests of its
own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks``, so it imports the port
and numpy only, never JAX.
"""

from __future__ import annotations

import numpy as np


def cli_and_api(mesh, argv: list) -> dict:
    """The training CLI in this rank of an in-process group (the
    reference the multi-process CLI is held to), then the multihost API
    on the same group."""
    import importlib

    import torch

    from fluxdistributed_tpu_torch.parallel import multihost
    from fluxdistributed_tpu_torch.sharding import P

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    task = cli.run(argv)
    out = {"losses": [float(v) for v in task.losses],
           "params": {k: v.detach().numpy().copy()
                      for k, v in task.model.state_dict().items()},
           # the rows this process fed for each item
           "rows": [task.loader._batch(i)["image"] for i in range(3)]}
    r = mesh.rank
    out["index"] = (multihost.process_index(), multihost.process_count(),
                    multihost.is_coordinator(), multihost.is_distributed())
    out["local_batch"] = multihost.local_batch_size(8)
    try:
        multihost.local_batch_size(7)
        out["odd_batch"] = None
    except ValueError as e:
        out["odd_batch"] = str(e)
    out["stop_one"] = multihost.agree_to_stop(r == 1)
    out["stop_none"] = multihost.agree_to_stop(False)
    out["bcast"] = multihost.broadcast_from_coordinator(
        {"rank": r, "tag": f"from {r}"})
    out["gathered"] = multihost.host_local_values(
        np.array([10.0 * r, 10.0 * r + 1], np.float32))
    g = multihost.global_batch({"x": np.arange(4, dtype=np.float32)
                                + 100.0 * r}, mesh)
    out["global"] = g.gather()["x"].numpy()
    out["global_spec"] = tuple(g.spec)
    host = np.arange(8, dtype=np.float32).reshape(4, 2)
    out["committed"] = multihost.commit_to_mesh(host, P("data"),
                                                mesh).numpy()
    multihost.sync_global_devices("test")
    out["device"] = str(torch.device(mesh.device))
    return out
