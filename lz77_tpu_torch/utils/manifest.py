"""Block manifest: checkpoint/resume sidecar (SURVEY.md §5).

The reference stream is not restartable — no block index, no length fields
(SURVEY.md §2.3.6).  The block decomposition makes every block boundary a
natural checkpoint: this sidecar records, per block, the token count, the
payload bit offset, and the parse entry offsets, kept strictly *out of band*
so the stream stays bit-compatible.

A partially written run can resume: completed blocks are skipped, the bit
cursor is re-established from the manifest, and encoding continues from the
recorded entry offset.

Own copy of the JAX package's ``utils.manifest``: the JSON layout is the
same, so a manifest written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

from .. import spec


@dataclasses.dataclass
class BlockRecord:
    index: int
    tokens: int
    bit_offset: int  # absolute bit position of this block's payload
    entry: int  # parse entry offset into this block
    next_entry: int  # parse entry offset carried to the next block


@dataclasses.dataclass
class Manifest:
    la: int
    sb: int
    block_size: int
    input_bytes: int
    # Record granularity: the host-parse pipeline appends one record per
    # BLOCK ('host'); the fused/sharded device pipelines append one record
    # per BATCH of batch_blocks blocks ('fused'/'sharded') — the device
    # step's natural checkpoint unit.  Old manifests (no key) load as 'host'.
    pipeline: str = "host"
    batch_blocks: int = 0
    blocks: list[BlockRecord] = dataclasses.field(default_factory=list)

    @property
    def width(self) -> int:
        return spec.token_width(self.la, self.sb)

    def completed(self) -> int:
        """Number of leading contiguous completed blocks."""
        n = 0
        for i, r in enumerate(self.blocks):
            if r.index != i:
                break
            n += 1
        return n

    def next_bit_offset(self) -> int:
        if not self.blocks:
            return spec.HEADER_BITS
        last = self.blocks[-1]
        return last.bit_offset + last.tokens * self.width

    def next_entry(self) -> int:
        return self.blocks[-1].next_entry if self.blocks else 0

    def append(self, tokens: int, entry: int, next_entry: int) -> None:
        self.blocks.append(
            BlockRecord(
                index=len(self.blocks),
                tokens=tokens,
                bit_offset=self.next_bit_offset(),
                entry=entry,
                next_entry=next_entry,
            )
        )

    def to_dict(self) -> dict:
        """The dict both packages store as JSON."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Manifest":
        """Inverse of :meth:`to_dict`; a manifest written before the
        ``pipeline`` / ``batch_blocks`` keys existed loads as 'host'."""
        m = cls(
            la=d["la"], sb=d["sb"], block_size=d["block_size"],
            input_bytes=d["input_bytes"],
            pipeline=d.get("pipeline", "host"),
            batch_blocks=d.get("batch_blocks", 0),
        )
        m.blocks = [BlockRecord(**b) for b in d["blocks"]]
        return m

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Manifest":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def compatible_with(
        self,
        params: spec.Params,
        block_size: int,
        input_bytes: int,
        pipeline: str = "host",
        batch_blocks: int = 0,
    ) -> bool:
        return (
            self.la == params.la
            and self.sb == params.sb
            and self.block_size == block_size
            and self.input_bytes == input_bytes
            and self.pipeline == pipeline
            and (self.pipeline == "host" or self.batch_blocks == batch_blocks)
        )
