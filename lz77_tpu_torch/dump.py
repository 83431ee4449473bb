"""Stream inspector: ``python -m lz77_tpu_torch.dump FILE [--limit N] [--json]``.

The debugging counterpart of the reference's only debug aid, the unused
in-order tree dump ``printtree`` (tree.c:269-279) — but aimed at the
artifact that actually matters here: the compressed stream.  Prints the
in-band header and one line per token (offset, length, next byte), plus a
summary (token count, literal/match split, padding bits).  Read-only; works
on streams produced by any backend or by the C reference binary.  Host
code only (no device): the port's copy of ``lz77_tpu.dump``, over the
port's own ``bitio`` and ``spec``, with the same text, JSON, messages and
exit codes.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import bitio, spec


def dump(data: bytes, limit: int | None = None, as_json: bool = False,
         out=None) -> None:
    out = out or sys.stdout
    params, off, length, nxt = bitio.parse_stream(data)
    T = int(off.shape[0])
    payload_bits = 8 * (len(data) - spec.HEADER_BYTES)
    info = {
        "sb": params.sb, "la": params.la,
        "token_bits": params.width, "tokens": T,
        "literals": int((off == 0).sum()),
        "matches": int((off != 0).sum()),
        "decoded_bytes": int(length.sum()) + T,
        "trailing_pad_bits": payload_bits - T * params.width,
    }
    n = T if limit is None else min(limit, T)
    if as_json:
        info["first_tokens"] = [
            {"off": int(off[i]), "len": int(length[i]), "next": int(nxt[i])}
            for i in range(n)
        ]
        out.write(json.dumps(info) + "\n")
        return
    out.write(
        f"header: sb={params.sb} la={params.la} "
        f"(offset {spec.bitof(params.sb)}b, length {spec.bitof(params.la)}b, "
        f"next 8b = {params.width}b/token)\n"
    )
    for i in range(n):
        c = int(nxt[i])
        ch = chr(c) if 32 <= c < 127 else f"\\x{c:02x}"
        kind = "lit  " if off[i] == 0 else "match"
        out.write(
            f"{i:8d}  {kind} off={int(off[i]):5d} len={int(length[i]):3d} "
            f"next={c:3d} {ch!r}\n"
        )
    if n < T:
        out.write(f"... {T - n} more tokens\n")
    out.write(
        f"{T} tokens ({info['literals']} literal, {info['matches']} match) "
        f"-> {info['decoded_bytes']} bytes; "
        f"{info['trailing_pad_bits']} trailing pad bits\n"
    )


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m lz77_tpu_torch.dump",
        description="Inspect an lz77 compressed stream token by token.",
    )
    p.add_argument("file", help="compressed stream (ours or the reference's)")
    p.add_argument("--limit", type=int, default=None,
                   help="print at most N tokens (default: all)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable summary + first --limit tokens")
    args = p.parse_args(argv)
    try:
        with open(args.file, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"Opening input file: {e.strerror}", file=sys.stderr)
        return 1
    try:
        dump(data, limit=args.limit, as_json=args.as_json)
    except ValueError as e:
        print(f"Error reading bits: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
