"""Conformance corpus: real corpora when available, labeled surrogates else.

SURVEY.md §4d calls for Canterbury + Silesia conformance.  This environment
has no network egress and no vendored corpora, so the corpus is resolved in
three tiers, each clearly labeled in the returned file names:

1. ``$LZ77_CORPUS_DIR`` — a directory of real corpus files (e.g. an unpacked
   Silesia/Canterbury).  Every regular file in it is used as ``real:<name>``.
2. System files — large, stable text/binary content shipped in the image
   (Python standard-library sources, shared libraries), used as
   ``system:<class>``.  Real data, deterministic for a given image.
3. Deterministic synthetic surrogates — seeded generators modeled on the
   Silesia file classes (english text, source code, XML, database records,
   DNA, binary), used as ``synthetic:<class>``.  Clearly labeled so nobody
   mistakes them for the real corpus.

The conformance runner (``python -m lz77_tpu_torch.conformance``) asserts,
per file: bit-exact roundtrip, cross-decode against the C reference binary
in both directions, and compressed size <= the reference encoder's.

The port's own copy of ``lz77_tpu.corpus`` (numpy only): ``get_corpus``
gives byte for byte the JAX package's files.
"""

from __future__ import annotations

import os
import sysconfig

import numpy as np

_WORDS = None


def _english_words(rng) -> list[bytes]:
    # Zipf-ish word pool with English-like letter frequencies.
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    probs = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3,
                      4.0, 2.8, 2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5,
                      1.0, 0.8, 0.2, 0.2, 0.1, 0.1])
    probs = probs / probs.sum()
    words = []
    for _ in range(4000):
        n = max(1, int(rng.normal(4.7, 2.2)))
        words.append(rng.choice(letters, size=min(n, 14), p=probs).tobytes())
    return words


def synth_english(n: int, seed: int = 1) -> bytes:
    """Word-salad English with Zipf word reuse (Silesia 'dickens' class)."""
    rng = np.random.default_rng(seed)
    words = _english_words(rng)
    ranks = rng.zipf(1.3, size=max(64, n // 5)) % len(words)
    parts, total = [], 0
    i = 0
    while total < n:
        w = words[int(ranks[i % len(ranks)])]
        sep = b". " if rng.random() < 0.06 else b" "
        parts.append(w + sep)
        total += len(w) + len(sep)
        i += 1
    return b"".join(parts)[:n]


def synth_source(n: int, seed: int = 2) -> bytes:
    """C-like source code (Silesia 'samba'/Canterbury 'fields.c' class)."""
    rng = np.random.default_rng(seed)
    idents = [bytes(rng.choice(np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyz_", np.uint8), size=rng.integers(3, 12)))
        for _ in range(120)]
    kw = [b"int ", b"return ", b"if (", b"for (", b"static ", b"void ",
          b"struct ", b"const ", b"char *", b"size_t "]
    lines, total = [], 0
    while total < n:
        ind = b"    " * int(rng.integers(0, 3))
        a = idents[int(rng.integers(0, len(idents)))]
        b = idents[int(rng.integers(0, len(idents)))]
        k = kw[int(rng.integers(0, len(kw)))]
        form = int(rng.integers(0, 4))
        if form == 0:
            line = ind + k + a + b" = " + b + b"[i];\n"
        elif form == 1:
            line = ind + b"if (" + a + b" < " + b + b") {\n"
        elif form == 2:
            line = ind + a + b"(" + b + b", sizeof(" + a + b"));\n"
        else:
            line = ind + b"}\n"
        lines.append(line)
        total += len(line)
    return b"".join(lines)[:n]


def synth_xml(n: int, seed: int = 3) -> bytes:
    """Tag-heavy XML (Silesia 'xml' class)."""
    rng = np.random.default_rng(seed)
    tags = [b"entry", b"name", b"value", b"item", b"record", b"field"]
    words = _english_words(rng)
    parts, total = [], 0
    while total < n:
        t = tags[int(rng.integers(0, len(tags)))]
        w = words[int(rng.integers(0, len(words)))]
        frag = b"<" + t + b' id="' + str(int(rng.integers(0, 9999))).encode() \
            + b'">' + w + b"</" + t + b">\n"
        parts.append(frag)
        total += len(frag)
    return b"".join(parts)[:n]


def synth_records(n: int, seed: int = 4) -> bytes:
    """Fixed-layout database records (Silesia 'nci'/'sao' class)."""
    rng = np.random.default_rng(seed)
    recs, total = [], 0
    while total < n:
        rid = int(rng.integers(0, 99999))
        v = rng.integers(0, 999, size=4)
        rec = (f"{rid:08d}|{v[0]:06d}|{v[1]:06d}|{v[2]:06d}|{v[3]:06d}|OK\n"
               ).encode()
        recs.append(rec)
        total += len(rec)
    return b"".join(recs)[:n]


def synth_dna(n: int, seed: int = 5) -> bytes:
    """4-symbol genome-like data with repeats (Canterbury 'E.coli' class)."""
    rng = np.random.default_rng(seed)
    base = rng.choice(np.frombuffer(b"acgt", np.uint8), size=max(n // 4, 256))
    out = []
    total = 0
    while total < n:
        # repeat a random earlier segment (genomes are repeat-rich)
        if total and rng.random() < 0.5:
            ln = int(rng.integers(20, 400))
            st = int(rng.integers(0, max(1, total - ln)))
            seg = b"".join(out)[st : st + ln]
        else:
            ln = int(rng.integers(50, 500))
            st = int(rng.integers(0, max(1, base.shape[0] - ln)))
            seg = base[st : st + ln].tobytes()
        out.append(seg)
        total += len(seg)
    return b"".join(out)[:n]


def synth_binary(n: int, seed: int = 6) -> bytes:
    """Executable-like binary: structured headers + code-ish + data (Silesia
    'mozilla'/'ooffice' class)."""
    rng = np.random.default_rng(seed)
    parts, total = [], 0
    opcodes = rng.integers(0, 256, 64, dtype=np.uint8)
    while total < n:
        kind = rng.random()
        if kind < 0.4:  # code: repetitive opcode patterns + varying operands
            m = int(rng.integers(64, 512))
            ops = opcodes[rng.integers(0, 64, m)]
            imm = rng.integers(0, 256, m, dtype=np.uint8)
            seg = np.stack([ops, imm], 1).tobytes()
        elif kind < 0.7:  # zero-padded tables
            seg = b"\x00" * int(rng.integers(32, 1024))
        else:  # compressed-ish resource data
            seg = rng.integers(0, 256, int(rng.integers(64, 512)),
                               dtype=np.uint8).tobytes()
        parts.append(seg)
        total += len(seg)
    return b"".join(parts)[:n]


SYNTH_CLASSES = {
    "english": synth_english,
    "source": synth_source,
    "xml": synth_xml,
    "records": synth_records,
    "dna": synth_dna,
    "binary": synth_binary,
}


def _system_files(scale: int) -> dict[str, bytes]:
    """Real file content shipped in the image (labeled ``system:``)."""
    out: dict[str, bytes] = {}
    # Python standard-library sources: genuine source-code corpus.
    stdlib = sysconfig.get_paths().get("stdlib")
    if stdlib and os.path.isdir(stdlib):
        bufs, total = [], 0
        cap = (2 << 20) * scale
        for name in sorted(os.listdir(stdlib)):
            if not name.endswith(".py"):
                continue
            try:
                with open(os.path.join(stdlib, name), "rb") as f:
                    b = f.read()
            except OSError:
                continue
            bufs.append(b)
            total += len(b)
            if total >= cap:
                break
        if bufs:
            out["system:python-src"] = b"".join(bufs)[:cap]
    return out


def get_corpus(scale: int = 1) -> dict[str, bytes]:
    """The conformance corpus: {label: bytes}.

    ``scale`` multiplies the per-file size (scale=1 -> ~1 MB files, good for
    CI; the benchmark runner uses larger scales).
    """
    corpus: dict[str, bytes] = {}
    real_dir = os.environ.get("LZ77_CORPUS_DIR")
    if real_dir and os.path.isdir(real_dir):
        for name in sorted(os.listdir(real_dir)):
            p = os.path.join(real_dir, name)
            if os.path.isfile(p):
                with open(p, "rb") as f:
                    corpus[f"real:{name}"] = f.read()
        if corpus:
            return corpus
    size = (1 << 20) * scale
    for cls, fn in SYNTH_CLASSES.items():
        corpus[f"synthetic:{cls}"] = fn(size)
    corpus.update(_system_files(scale))
    # canonical stress classes (always included)
    rng = np.random.default_rng(99)
    corpus["stress:zeros"] = b"\x00" * size
    corpus["stress:random"] = rng.integers(
        0, 256, size // 4, dtype=np.uint8
    ).tobytes()
    return corpus
