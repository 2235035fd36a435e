"""Sweep the standard-ambiguity settings for best conformance.

Python equivalent of the reference's src/optimize_settings.hs: evaluate all
2^5 combinations of the Settings flags on the BS.1387 conformance items and
report DI RMSE against the ITU reference values (and against the C
implementation's blessed outputs).  Requires CONFORMANCEDATADIR.

Run:  python tools/optimize_settings.py [--advanced]
"""

import argparse
import itertools
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from gstpeaq_jax import conformance
from gstpeaq_jax.constants import Settings

FLAGS = [
    "swap_mod_patts_for_noise_loudness_movs",
    "center_ehs_correlation_window",
    "ehs_subtract_dc_before_window",
    "use_floor_for_steps_above_threshold",
    "clamp_movs",
]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--advanced", action="store_true")
    parser.add_argument("--precision", default=None)
    args = parser.parse_args()
    if conformance.data_dir() is None:
        print("CONFORMANCEDATADIR not set, sweep NOT run.")
        return 77
    results = []
    for bits in itertools.product([False, True], repeat=len(FLAGS)):
        settings = Settings(**dict(zip(FLAGS, bits)))
        rows = conformance.run(args.advanced, args.precision,
                               settings=settings)
        d_itu = np.array([r.delta_itu for r in rows])
        rmse = float(np.sqrt((d_itu ** 2).mean()))
        results.append((rmse, bits))
        print(f"{''.join(str(int(b)) for b in bits)}  RMSE {rmse:.4f}",
              flush=True)
    results.sort()
    best_rmse, best_bits = results[0]
    print("\nbest:", dict(zip(FLAGS, best_bits)), f"RMSE {best_rmse:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
