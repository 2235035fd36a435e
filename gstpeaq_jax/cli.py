"""Command-line front-end mirroring the reference `peaq` binary.

Usage:  python -m gstpeaq_jax [--basic | --advanced] [--version]
                              [--console-output] REFFILE TESTFILE
Prints "Objective Difference Grade: %.3f" and "Distortion Index: %.3f"
exactly like src/peaq.c:217-220; --console-output additionally dumps the
MOVs like src/gstpeaq.c:1022-1061.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from . import api
from . import constants as C
from .utils import native

_BASIC_FMT = [
    ("   BandwidthRefB", "BandwidthRefB"),
    ("  BandwidthTestB", "BandwidthTestB"),
    ("      Total NMRB", "TotalNMRB"),
    ("    WinModDiff1B", "WinModDiff1B"),
    ("            ADBB", "ADBB"),
    ("            EHSB", "EHSB"),
    ("    AvgModDiff1B", "AvgModDiff1B"),
    ("    AvgModDiff2B", "AvgModDiff2B"),
    ("   RmsNoiseLoudB", "RmsNoiseLoudB"),
    ("           MFPDB", "MFPDB"),
    ("  RelDistFramesB", "RelDistFramesB"),
]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="peaq",
        description=("peaq computes the Objective Difference Grade based on "
                     "ITU-R BS.1387-1 (but it does not meet its conformance "
                     "requirements)."))
    parser.add_argument("--advanced", action="store_true",
                        help="use advanced version")
    parser.add_argument("--basic", action="store_true",
                        help="use basic version (default)")
    parser.add_argument("--version", action="store_true")
    parser.add_argument("--console-output", action="store_true",
                        help="also print the model output variables")
    parser.add_argument("--playback-level", type=float, default=92.0)
    parser.add_argument("--precision",
                        choices=["float32", "float64", "mixed", "accurate"],
                        default=None, help="compute precision (default: "
                        "float64 when jax_enable_x64 is set, else accurate; "
                        "float32 is the max-throughput opt-in)")
    parser.add_argument("--totalsnr", action="store_true",
                        help="also print the overall SNR in dB (the "
                        "reference's totalsnr element property)")
    parser.add_argument("--bands", type=int, default=None, metavar="N",
                        help="FFT-ear band count 55..109, basic mode only "
                        "(the reference's number-of-bands property)")
    parser.add_argument("files", nargs="*", metavar="REFFILE TESTFILE")
    args = parser.parse_args(argv)

    if args.version:
        print(f"gstpeaq-jax {__version__}")
        return 0
    if len(args.files) != 2:
        parser.print_help()
        return 1
    if args.advanced and args.basic:
        print("cannot select both --basic and --advanced", file=sys.stderr)
        return 1

    # native C loader when built (make -C native), wavio fallback otherwise
    try:
        ref = native.load_audio_48k(args.files[0])
        test = native.load_audio_48k(args.files[1])
    except (IOError, ValueError) as exc:
        print(f"peaq: {exc}", file=sys.stderr)
        return 2
    if ref.shape[1] != test.shape[1]:
        # mirror the pipeline's caps negotiation: upmix mono to match
        if ref.shape[1] == 1:
            ref = ref.repeat(test.shape[1], axis=1)
        elif test.shape[1] == 1:
            test = test.repeat(ref.shape[1], axis=1)
        else:
            print("channel count mismatch", file=sys.stderr)
            return 1

    res = api.peaq(ref, test, advanced=args.advanced,
                   playback_level=args.playback_level, dtype=args.precision,
                   return_snr=args.totalsnr, band_count=args.bands)

    if args.console_output:
        if args.advanced:
            for name in C.MOV_ADVANCED_NAMES:
                print(f"{name} = {res.movs[name]:f}")
        else:
            for label, name in _BASIC_FMT:
                print(f"{label}: {res.movs[name]:f}")
    print(f"Objective Difference Grade: {res.odg:.3f}")
    print(f"Distortion Index: {res.di:.3f}")
    if args.totalsnr:
        # reference exposes this as the element's totalsnr property
        # (src/gstpeaq.c:493-497); printed here since there is no GObject
        print(f"Total SNR: {res.total_snr_db:.3f} dB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
