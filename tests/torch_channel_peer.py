"""The far end of the port's cross-process channel tests: functions a
``spawn``ed process runs. This module imports neither JAX nor ``ray_tpu``,
so a child starts with PyTorch and the port only."""

import torch

from ray_tpu_torch.experimental import ChannelClosed, DeviceChannel


def tree(i, device="cpu"):
    """The test_dag.py payload: write i of a DeviceChannel's producer."""
    return {"x": torch.arange(8, dtype=torch.float32, device=device) + i,
            "w": torch.full((2, 2), i, dtype=torch.bfloat16, device=device)}


def read_trees(path, n, device, out):
    """Read ``n`` payloads of {"x": f32 [8], "w": bf16 [2, 2]} from the
    DeviceChannel at ``path`` onto ``device``, then expect ChannelClosed.
    Payload i must be ``tree(i)``, bit for bit. Puts x[0] of each, w's
    dtypes, whether each leaf is a tensor on ``device``, whether each
    equals ``tree(i)``, closed, and the counters on ``out``."""
    try:
        ch = DeviceChannel(path, device=device)
        firsts, dtypes, placed, equal = [], [], [], []
        for i in range(n):
            v = ch.read(timeout=60)
            firsts.append(float(v["x"][0]))
            dtypes.append(str(v["w"].dtype))
            placed.append(all(isinstance(t, torch.Tensor)
                              and t.device.type == torch.device(device).type
                              for t in v.values()))
            equal.append(all(torch.equal(v[k].cpu(), t)
                             for k, t in tree(i).items()))
        try:
            ch.read(timeout=5)
            closed = False
        except ChannelClosed:
            closed = True
        ch.close()
        out.put({"firsts": firsts, "dtypes": dtypes, "placed": placed,
                 "equal": equal, "closed": closed,
                 "ipc_transfers": DeviceChannel.ipc_transfers,
                 "host_lane_bytes": DeviceChannel.host_lane_bytes})
    except Exception as e:   # the parent reports what failed here
        out.put({"error": repr(e)})
