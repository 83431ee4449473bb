"""Command-line entry point, flag-compatible with the reference binary.

Same surface as main.c:50-58: ``-c -d -i -o -l -s -h`` with identical
validation ranges (la in [2,255], sb in [0,65535] — main.c:35-38), identical
duplicate-flag rejection, plus extensions that never leak into the stream
format: block size, batch size, matcher, pipeline, manifest, stats report.

The surface, the validation order, every message and the exit codes are the
JAX package's CLI's (``lz77_tpu/cli.py``), so a command line written for it
runs here.  What differs follows from the device rule: ``--backend`` is
``device|native|numpy`` and ``--decode-backend`` is ``device|host|native``,
both ``device`` by default, and nothing falls back; ``--device cuda|cpu``
takes the place of ``--platform`` (``cpu`` runs the kernels' plain PyTorch
versions); ``--matcher`` takes this package's two kernels (``sweep``, the
default, and ``chunk``), the JAX package's XLA matchers as plain tensor
code (``brute``, ``sorted``, ``chunked``, ``bitplane``) and the JAX names
of the two TPU kernels as aliases (``pallas_bitplane``, ``pallas``).
``--pipeline sharded`` runs over a mesh of devices (``--mesh DATAxWIN``;
default every visible card on the data axis); ``--host-devices N`` gives
the mesh N members on the device that ``--device`` names (``cpu`` unless
``--device`` is given, as the JAX flag implies ``--platform cpu``), so
``--device cuda --host-devices 8 --mesh 4x2`` runs a 4x2 mesh on one card.

Divergence (SURVEY.md §2.3.8): sb values of 0, 1 or exact powers of two are
rejected by default because the reference encoder corrupts data for them;
``--force-sb`` accepts them anyway using the safe restricted distance limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import spec

DEFAULT_MATCHER = "sweep"  # ops.match.DEFAULT_MATCHER, without importing torch

# Verbatim usage text of the reference (main.c:118-125); printed by -h.
USAGE_TEXT = (
    "Usage: lz77 <options>\n"
    "  -c : Encode input file to output file.\n"
    "  -d : Decode input file to output file.\n"
    "  -i <filename> : Name of input file.\n"
    "  -o <filename> : Name of output file.\n"
    "  -l <value> : Lookahead size (default 15)\n"
    "  -s <value> : Search-buffer size (default 4095)\n"
    "  -h : Command line options.\n\n"
)


class _UsageAction(argparse.Action):
    """Print usage and KEEP PARSING, like the reference's ``case 'h'`` which
    ``break``s back into the getopt loop instead of exiting (main.c:117-126).
    ``lz77 -h`` alone therefore prints usage and then fails validation with
    "Input file must be provided", exactly like the C binary."""

    def __init__(self, option_strings, dest, **kwargs):
        super().__init__(option_strings, dest, nargs=0, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        print(USAGE_TEXT, end="")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lz77",
        description="LZ77 codec on PyTorch/CUDA "
                    "(stream-compatible with cstdvd/lz77)",
        add_help=False,
    )
    p.add_argument("-c", dest="mode", action="store_const", const="encode",
                   help="Encode input file to output file.")
    p.add_argument("-d", dest="mode", action="store_const", const="decode",
                   help="Decode input file to output file.")
    p.add_argument("-i", dest="input", action="append",
                   help="Name of input file.")
    p.add_argument("-o", dest="output", action="append",
                   help="Name of output file.")
    p.add_argument("-l", dest="la", type=int, default=None,
                   help="Lookahead size (default 15)")
    p.add_argument("-s", dest="sb", type=int, default=None,
                   help="Search-buffer size (default 4095)")
    p.add_argument("-h", action=_UsageAction,
                   help="Command line options.")
    # Extensions (out-of-band: never affect the stream format).
    p.add_argument("--block-size", type=int, default=None,
                   help="Encoder block size in bytes (device parallel unit)")
    p.add_argument("--batch-blocks", type=int, default=None,
                   help="Blocks encoded per device batch")
    p.add_argument("--matcher", default=DEFAULT_MATCHER,
                   help="Match finder: sweep (default) or chunk (kernels), "
                        "brute, sorted, chunked or bitplane (tensor code); "
                        "pallas_bitplane and pallas are aliases of sweep "
                        "and chunk.  All exact, same streams")
    p.add_argument("--manifest", default=None,
                   help="Checkpoint manifest path (enables resumable encode)")
    p.add_argument("--resume", action="store_true",
                   help="Resume a previous encode from --manifest")
    p.add_argument("--backend", choices=("device", "native", "numpy"),
                   default="device", help="Execution backend")
    p.add_argument("--pipeline", choices=("host", "fused", "sharded"),
                   default="host",
                   help="device-backend encode pipeline: 'host' = device "
                        "match + host parse; 'fused' = device-resident "
                        "match+parse+pack (byte-aligned token widths); "
                        "'sharded' = the same over a device mesh (see "
                        "--mesh)")
    p.add_argument("--mesh", default=None, metavar="DATAxWIN",
                   help="Device mesh shape for --pipeline sharded, e.g. "
                        "4x2 (data x win); default: every member on the "
                        "data axis")
    p.add_argument("--decode-backend",
                   choices=("device", "host", "native"), default=None,
                   help="device-backend decoder (default device): 'device' "
                        "= the walk-decode kernel, streamed stage by stage; "
                        "'native' = the C++ streamed decoder; 'host' = "
                        "numpy (the backend that ran is recorded in "
                        "--report)")
    p.add_argument("--threads", type=int, default=None,
                   help="Native-backend encoder threads. Default/1: streamed "
                        "O(window)-memory encode; >1: in-memory block-"
                        "parallel encoder (byte-identical streams either way)")
    p.add_argument("--force-sb", action="store_true",
                   help="Accept degenerate -s values the reference corrupts "
                        "(0/1/powers of two); encoded safely, not corruptly")
    p.add_argument("--report", action="store_true",
                   help="Print a JSON run report to stderr")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Capture a torch.profiler trace into DIR")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="Where the device backend runs (default cuda; "
                        "raises without a card).  'cpu' runs the kernels' "
                        "plain PyTorch versions on the host")
    p.add_argument("--host-devices", type=int, default=None, metavar="N",
                   help="Mesh members for --pipeline sharded, all on the "
                        "--device (which defaults to cpu with this flag); "
                        "e.g. '--host-devices 8 --pipeline sharded --mesh "
                        "4x2', or with --device cuda on one card")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    # Reference-compatible validation (main.c:82-95, 101-115, 132-139).
    if args.input and len(args.input) > 1:
        print("Multiple input files not allowed.", file=sys.stderr)
        return 1
    if args.output and len(args.output) > 1:
        print("Multiple output files not allowed.", file=sys.stderr)
        return 1
    if args.la is not None and not (
        spec.MIN_LA_SIZE <= args.la <= spec.MAX_LA_SIZE
    ):
        print("Bad lookahead size value.", file=sys.stderr)
        return 1
    if args.sb is not None and not (0 <= args.sb <= spec.MAX_SB_SIZE):
        print("Bad search-buffer size value.", file=sys.stderr)
        return 1
    if not args.input:
        print("Input file must be provided", file=sys.stderr)
        return 1
    if not args.output:
        print("Output file must be provided", file=sys.stderr)
        return 1
    if args.mode is None:
        print("Select ENCODE or DECODE mode", file=sys.stderr)
        return 1
    # Our divergence check runs LAST so every reference-compatible validation
    # error above fires in the reference's order (main.c:69-139 has no
    # degenerate-sb concept at all).
    if args.sb is not None and spec.is_degenerate_sb(args.sb):
        if not args.force_sb or args.sb < 1:
            print(
                f"Search-buffer size {args.sb} is degenerate: the reference "
                "encoder corrupts data for 0, 1 and powers of two "
                "(bitof(2^k)=k cannot hold offset 2^k). Use a non-power "
                "size, or --force-sb to encode safely anyway.",
                file=sys.stderr,
            )
            return 1

    la = args.la if args.la is not None else spec.DEFAULT_LA_SIZE
    sb = args.sb if args.sb is not None else spec.DEFAULT_SB_SIZE
    params = spec.Params(la=la, sb=sb)

    if args.host_devices:
        if args.host_devices < 1:
            print("--host-devices must be >= 1", file=sys.stderr)
            return 1
        if args.device is None:
            args.device = "cpu"

    if (
        args.mode == "decode"
        and args.decode_backend is not None
        and args.backend in ("native", "numpy")
    ):
        print(
            f"warning: --decode-backend {args.decode_backend} only applies "
            f"to --backend device; ignored with --backend {args.backend}",
            file=sys.stderr,
        )
    decode_backend = args.decode_backend or "device"

    # Probe the input for the reference-compatible open error without
    # reading it: the streamed paths below read it in bounded chunks.
    try:
        open(args.input[0], "rb").close()
    except OSError as e:
        print(f"Opening input file: {e.strerror}", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    # Streamed file-to-file decode (the default decode route): O(window)
    # memory for any stream size, like the reference (lz77.c:148-197).
    if args.mode == "decode" and (
        args.backend == "native"
        or (args.backend == "device"
            and decode_backend in ("native", "device"))
    ):
        try:
            if args.backend == "device" and decode_backend == "device":
                # streamed DEVICE decode: the history window carried across
                # kernel stages, bounded host memory at any stream size
                from .models import codec
                from .utils import profiling

                st = codec.DecodeStats()
                with profiling.trace(args.profile):
                    n_out = codec.decode_file(
                        args.input[0], args.output[0], backend="device",
                        stats=st, device=args.device,
                    )
                in_bytes = st.input_bytes
                backend_used = st.backend
            else:
                # Pure-native streamed route: no torch import on the decode
                # hot path (matters for CLI latency on small files).
                import os as os_lib

                from . import native as native_lib

                in_bytes = os_lib.path.getsize(args.input[0])
                n_out = native_lib.decode_file(args.input[0], args.output[0])
                backend_used = "native-streamed"
        except OSError as e:
            print(f"Opening output file: {e.strerror}", file=sys.stderr)
            return 1
        except (ValueError, RuntimeError) as e:
            print(f"Error reading bits: {e}", file=sys.stderr)
            return 1
        if args.report:
            dt = time.perf_counter() - t0
            print(json.dumps({
                "mode": "decode", "backend": args.backend,
                "decode_backend": backend_used,
                "seconds": round(dt, 6), "input_bytes": in_bytes,
                "output_bytes": n_out,
                "mb_per_s": round(n_out / dt / 1e6, 3) if dt > 0 else None,
                "peak_rss_mb": _peak_rss_mb(),
            }), file=sys.stderr)
        return 0

    # native-backend encode streams file-to-file in O(window) memory (the
    # reference's FILE-loop profile, lz77.c:51-140) unless the caller asks
    # for the in-memory block-parallel path with --threads > 1.  Streams
    # are byte-identical either way.
    if (
        args.mode == "encode"
        and args.backend == "native"
        and args.threads in (None, 1)
    ):
        from . import native as native_lib

        try:
            n_in, n_out = native_lib.encode_file(
                args.input[0], args.output[0], params
            )
        except OSError as e:
            print(f"Opening output file: {e.strerror}", file=sys.stderr)
            return 1
        except (ValueError, RuntimeError) as e:
            print(f"Encode error: {e}", file=sys.stderr)
            return 1
        if args.report:
            dt = time.perf_counter() - t0
            print(json.dumps({
                "mode": "encode", "backend": "native-streamed",
                "seconds": round(dt, 6), "input_bytes": n_in,
                "output_bytes": n_out,
                "ratio": round(n_out / n_in, 6) if n_in else None,
                "mb_per_s": round(n_in / dt / 1e6, 3) if dt > 0 else None,
                "peak_rss_mb": _peak_rss_mb(),
            }), file=sys.stderr)
        return 0

    # device-backend encode streams file-to-file (memmap input + page release,
    # payload appended as batches land — bounded memory at any input size,
    # like the reference's FILE loop), with or without a manifest.  The one
    # exception: a non-byte-aligned width under the fused pipeline goes to
    # the in-memory bytes path, which rejects it with the pipeline's message.
    if (
        args.mode == "encode"
        and args.backend == "device"
        and (args.pipeline == "host" or params.width % 8 == 0)
    ):
        from .models import codec

        stats = codec.EncodeStats()
        try:
            kwargs = _block_kwargs(args, params)
            if args.pipeline == "sharded":
                _sharded_kwargs(args, kwargs)
            else:
                kwargs["device"] = args.device
            from .utils import profiling

            with profiling.trace(args.profile):
                codec.encode_file(
                    args.input[0], args.output[0], params,
                    matcher=args.matcher, stats=stats,
                    manifest_path=args.manifest,
                    resume=args.resume, pipeline=args.pipeline, **kwargs,
                )
        except (ValueError, RuntimeError) as e:
            print(f"Encode error: {e}", file=sys.stderr)
            return 1
        if args.report:
            dt = time.perf_counter() - t0
            rep = {
                "mode": "encode", "backend": "device",
                "resumable": bool(args.manifest),
                "pipeline": args.pipeline, "matcher": args.matcher,
                "seconds": round(dt, 6), "input_bytes": stats.input_bytes,
                "output_bytes": stats.output_bytes, "tokens": stats.tokens,
                "blocks": stats.blocks, "ratio": round(stats.ratio, 6),
                "page_release": stats.page_release,
                "mb_per_s": round(stats.input_bytes / dt / 1e6, 3)
                if dt > 0 else None,
                "phases": {
                    k: round(v, 6)
                    for k, v in stats.phases.as_dict().items()
                },
                "peak_rss_mb": _peak_rss_mb(),
            }
            if stats.h2d_bytes:
                rep["h2d_bytes"] = stats.h2d_bytes
                rep["d2h_bytes"] = stats.d2h_bytes
            if stats.shards:
                rep["shards"] = stats.shards
                rep["resyncs"] = stats.resyncs
                rep["resync_head_tokens"] = stats.resync_head_tokens
                rep["resync_bulk"] = stats.resync_bulk
            print(json.dumps(rep), file=sys.stderr)
        return 0

    # Remaining paths (numpy/native backends; the host decode backend;
    # non-byte-aligned fused encode) operate on in-memory bytes.
    try:
        with open(args.input[0], "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"Opening input file: {e.strerror}", file=sys.stderr)
        return 1
    try:
        from .utils import profiling

        with profiling.trace(args.profile):
            if args.mode == "encode":
                result, report = _encode(data, params, args)
            else:
                result, report = _decode(data, args, decode_backend)
    except (ValueError, RuntimeError) as e:
        # Clean diagnostic, nonzero exit.  Decode failures mirror the
        # reference's stream-error wording (lz77.c:273-277); encode-side
        # errors (bad parameters, backend limits) get an honest message
        # instead of a misleading bit-read complaint.
        if args.mode == "decode":
            print(f"Error reading bits: {e}", file=sys.stderr)
        else:
            print(f"Encode error: {e}", file=sys.stderr)
        return 1
    dt = time.perf_counter() - t0

    try:
        with open(args.output[0], "wb") as f:
            f.write(result)
    except OSError as e:
        print(f"Opening output file: {e.strerror}", file=sys.stderr)
        return 1

    if args.report:
        report.update(
            mode=args.mode,
            seconds=round(dt, 6),
            input_bytes=len(data),
            output_bytes=len(result),
            mb_per_s=round(len(data) / dt / 1e6, 3) if dt > 0 else None,
            peak_rss_mb=_peak_rss_mb(),
        )
        print(json.dumps(report), file=sys.stderr)
    return 0


def _peak_rss_mb() -> float:
    """This process's own peak RSS (MB) — the number that pins bounded-
    memory claims in --report (a parent's getrusage(RUSAGE_CHILDREN) max
    is polluted by fork-time COW inheritance and unrelated children)."""
    import resource

    return round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1
    )


def _block_kwargs(args, params: spec.Params) -> dict:
    """Encoder batching knobs (never affect the stream format); also
    resolves ``args.matcher`` to this package's name for it."""
    from .ops import match as match_ops

    args.matcher = match_ops.route_matcher(args.matcher)
    kwargs = {}
    if args.block_size:
        kwargs["block_size"] = args.block_size
    if args.batch_blocks:
        kwargs["batch_blocks"] = args.batch_blocks
    return kwargs


def _sharded_kwargs(args, kwargs: dict) -> None:
    """Set the sharded pipeline's ``mesh`` in ``kwargs``: the (data, win)
    shape from --mesh (default: all members on data) over --host-devices
    members on --device, else one member on ``--device cpu``, else every
    visible card; ``batch_blocks`` defaults to twice its data axis."""
    from .parallel import mesh as mesh_lib

    if args.host_devices:
        devices = [args.device] * args.host_devices
    elif args.device == "cpu":
        devices = ["cpu"]
    else:
        devices = None
    shape = {}
    if args.mesh:
        try:
            shape["n_data"], shape["n_win"] = (
                int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            raise ValueError(
                f"--mesh must look like '4x2', got {args.mesh!r}"
            ) from None
    kwargs["mesh"] = mesh_lib.make_mesh(devices=devices, **shape)
    kwargs.setdefault("batch_blocks",
                      2 * kwargs["mesh"].shape[mesh_lib.DATA_AXIS])


def _encode(data: bytes, params: spec.Params, args):
    if args.backend == "numpy":
        from .models import spec_np

        return spec_np.encode(data, params), {"backend": "numpy"}
    if args.backend == "native":
        from . import native

        return (
            native.encode(data, params, threads=args.threads),
            {"backend": "native", "threads": args.threads or "auto"},
        )
    from .models import codec

    stats = codec.EncodeStats()
    kwargs = _block_kwargs(args, params)
    if args.pipeline == "sharded":
        from .parallel import sharded

        _sharded_kwargs(args, kwargs)
        out = sharded.encode_bytes_sharded(
            data, params, matcher=args.matcher, stats=stats, **kwargs,
        )
    else:
        out = codec.encode_bytes(
            data, params, pipeline=args.pipeline, matcher=args.matcher,
            stats=stats, device=args.device, **kwargs,
        )
    return out, {
        "backend": "device",
        "pipeline": args.pipeline,
        "matcher": args.matcher,
        "tokens": stats.tokens,
        "blocks": stats.blocks,
        "ratio": round(stats.ratio, 6),
        "phases": {
            k: round(v, 6) for k, v in stats.phases.as_dict().items()
        },
    }


def _decode(data: bytes, args, decode_backend: str):
    if args.backend == "numpy":
        from .models import spec_np

        return spec_np.decode(data), {"backend": "numpy"}
    if args.backend == "native":
        from . import native

        return native.decode(data), {"backend": "native"}
    from .models import codec

    st = codec.DecodeStats()
    out = codec.decode_bytes(
        data, backend=decode_backend, stats=st, device=args.device
    )
    return out, {"backend": "device", "decode_backend": st.backend}


if __name__ == "__main__":
    sys.exit(main())
