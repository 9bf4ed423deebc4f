"""North-star end-to-end benchmark on one GPU.

    python bench.py

The deployment: a 256x256 hexa gaussian map (65,536 units) trained for
one lap over 2^20 x 64-dim samples from a 16-centre gaussian mixture,
streamed to SOMTrainer in 16,384-sample chunks at B=4096 (alpha 0.05,
radius 64), then the fast qerror over all samples.  The lap runs twice:
with the input stream in float32 and in bfloat16 (stream_bf16).
Compilation is excluded by a warm-up fit and eval at the same shapes;
every timed region ends with a host fetch of its result.

Prints one JSON line: the device as JAX reports it, the card's name and
power limit, and the wall seconds and qerror of each lap.  Exits
non-zero on any backend but the GPU.  Named cells with per-layer
metrics replace this in the benchmark work of ROADMAP A1.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

N_SAMPLES = 1 << 20
CHUNK = 16384
BATCH = 4096
XDIM = YDIM = 256
DIM = 64


def run_e2e_1m_65k(stream_bf16: bool) -> dict:
    from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
    from som_lvq_pak_tpu.models.som import find_qerror, randinit
    from som_lvq_pak_tpu.models.trainer import SOMTrainer
    from som_lvq_pak_tpu.utils.rng import CRandom

    rng = np.random.default_rng(7)
    centres = rng.normal(0, 4.0, size=(16, DIM)).astype(np.float32)
    X = (centres[rng.integers(0, 16, size=N_SAMPLES)]
         + rng.normal(0, 1.0, size=(N_SAMPLES, DIM)).astype(np.float32))
    crng = CRandom()
    crng.init_random(123)
    codes = randinit(Dataset(points=X), topol=Topology.HEXA,
                     neigh=Neighborhood.GAUSSIAN, xdim=XDIM, ydim=YDIM,
                     rng=crng)

    def stream(total):
        for s in range(0, total, CHUNK):
            yield Dataset(points=X[s % N_SAMPLES:s % N_SAMPLES + CHUNK])

    def fit(rlen):
        return SOMTrainer(codes, batch_size=BATCH,
                          stream_bf16=stream_bf16).fit(
            stream(rlen), rlen=rlen, alpha=0.05, radius=64)

    data_dev = Dataset(points=jnp.asarray(X))
    find_qerror(fit(2 * BATCH), data_dev, mode="fast")   # compile
    t0 = time.perf_counter()
    out = fit(N_SAMPLES)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = find_qerror(out, data_dev, mode="fast") / N_SAMPLES
    t_eval = time.perf_counter() - t0
    return {"train_s": t_train, "qerror_eval_s": t_eval,
            "qerror_per_sample": q,
            "samples_per_s": N_SAMPLES / t_train}


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 2
    from som_lvq_pak_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    result = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "shape": "256x256 hexa gaussian map, 2^20 x 64 streamed, 1 lap, B=4096",
        "f32_stream": run_e2e_1m_65k(stream_bf16=False),
        "bf16_stream": run_e2e_1m_65k(stream_bf16=True),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
