"""PyTorch port: golden tests/golden/smpc_chance.npz replayed through the
port's SMPC.optimize on the CPU in float64 (its GP carried across from the
golden's JAX GP): max|u - u_gold| < 1e-4 at every step, the BASELINE
acceptance."""
import os

import numpy as np
import torch

from test_torch_smpc_solve import port_golden

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "smpc_chance.npz")


def test_golden_smpc_chance_replay():
    data = np.load(GOLDEN)
    ctl = port_golden()
    devs = []
    for k in range(data["U_gold"].shape[0]):
        u = ctl.optimize(data["X_meas"][k])
        assert ctl.stats["converged"]
        devs.append(float(np.abs(u - data["U_gold"][k]).max()))
    assert len(devs) == 25 and max(devs) < 1e-4, devs
