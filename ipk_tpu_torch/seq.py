"""Sequence alphabets and k-mer codec.

The port's own copy of ``ipk_tpu/seq.py``: only its imports differ,
so numerics, ordering, formats and messages stay those of the reference.

TPU-first counterpart of the reference's compile-time ``i2l::seq_traits``
(reference: SURVEY.md §2.2; usage pinned by ``ipk/src/ar.cpp:221-240``,
``ipk/src/pk_compute.cpp:96-105``, ``ipk/src/alignment.cpp:149,210,306``).
Unlike the reference — which compiles three binaries (ipk-dna/ipk-aa/ipk-aa-pos,
``ipk/CMakeLists.txt:41-118``) — the alphabet here is a runtime object: one
``SeqTraits`` instance per alphabet, and σ is just a tensor dimension.

Key packing (must match reference semantics exactly, ``pk_compute.cpp:96-105``):
``key = sum(code_i << (bits_per_symbol * (k - 1 - i)))`` — MSB-first, with
*bit* strides (base-32 for amino acids, not base-20).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = [
    "SeqTraits",
    "DNA",
    "AA",
    "get_traits",
    "encode_kmer",
    "decode_kmer",
    "dense_index_to_key",
    "key_to_dense_index",
]


@dataclasses.dataclass(frozen=True)
class SeqTraits:
    """Runtime description of a sequence alphabet.

    Mirrors the contract of ``i2l::seq_traits`` inferred from IPK call sites
    (SURVEY.md §2.2): alphabet_size, bits_per_symbol, max_kmer_length, name,
    gap/ambiguity predicates and char→code mapping.
    """

    name: str                      # serialized into the DB header ("nucl"/"amino")
    letters: str                   # code -> canonical uppercase letter
    bits_per_symbol: int
    max_kmer_length: int
    gap_chars: frozenset
    ambiguous_chars: frozenset
    aliases: Dict[str, str]        # extra char -> canonical letter (e.g. DNA "U" -> "T")

    @property
    def alphabet_size(self) -> int:
        return len(self.letters)

    @property
    def sigma(self) -> int:
        return len(self.letters)

    def char_to_code(self) -> Dict[str, int]:
        """char (upper or lower) -> integer code; includes aliases."""
        table = {}
        for code, ch in enumerate(self.letters):
            table[ch] = code
            table[ch.lower()] = code
        for alias, target in self.aliases.items():
            code = self.letters.index(target)
            table[alias] = code
            table[alias.lower()] = code
        return table

    def is_gap(self, ch: str) -> bool:
        return ch in self.gap_chars

    def is_ambiguous(self, ch: str) -> bool:
        return ch.upper() in self.ambiguous_chars or ch in self.gap_chars

    def get_gap(self) -> str:
        return "-"

    def key_to_code(self, ch: str):
        """char -> code or None if unsupported (cf. ``alignment.cpp:210``)."""
        return self.char_to_code().get(ch)

    # ---- vectorized helpers (used by the dense TPU path) ----

    def codes_lut(self) -> np.ndarray:
        """256-entry byte->code LUT; unsupported/gap bytes map to -1."""
        lut = np.full(256, -1, dtype=np.int16)
        for ch, code in self.char_to_code().items():
            lut[ord(ch)] = code
        return lut

    def gap_lut(self) -> np.ndarray:
        """256-entry byte->bool LUT for gap characters."""
        lut = np.zeros(256, dtype=bool)
        for ch in self.gap_chars:
            lut[ord(ch)] = True
        return lut


#: DNA column order A,C,G,T — matches the raxml-ng posterior column order used
#: verbatim by the reference (``ar.cpp:222-225``).
DNA = SeqTraits(
    name="nucl",
    letters="ACGT",
    bits_per_symbol=2,
    max_kmer_length=31,   # CHANGELOG.txt v0.3.1 (31*2 = 62 bits <= 64)
    gap_chars=frozenset("-.!*"),
    ambiguous_chars=frozenset("NRYSWKMBDHV"),
    aliases={"U": "T"},
)

#: Amino-acid order r,h,k,d,e,s,t,n,q,c,g,p,a,i,l,m,f,w,y,v — the i2l/RAPPAS
#: encoding order into which raxml-ng columns are permuted (``ar.cpp:227-234``).
#: max_kmer_length: CHANGELOG v0.3.1 claims 13, but 13*5 = 65 bits overflows a
#: 64-bit key under the shift-packing rule (``pk_compute.cpp:99``); we enforce 12.
AA = SeqTraits(
    name="amino",
    letters="RHKDESTNQCGPAILMFWYV",
    bits_per_symbol=5,
    max_kmer_length=12,
    gap_chars=frozenset("-.!*"),
    ambiguous_chars=frozenset("XBZJUO"),
    aliases={},
)

_TRAITS = {"nucl": DNA, "dna": DNA, "amino": AA, "aa": AA}


def get_traits(states: str) -> SeqTraits:
    """Resolve ``--states nucl|amino`` (``ipk.py:89-93``) to traits."""
    try:
        return _TRAITS[states.lower()]
    except KeyError:
        raise ValueError(f"Unknown sequence type: {states!r} (expected nucl/amino)")


def encode_kmer(kmer: str, traits: SeqTraits = DNA) -> int:
    """Encode a k-mer string into its packed integer key (MSB-first)."""
    table = traits.char_to_code()
    bits = traits.bits_per_symbol
    key = 0
    for ch in kmer:
        code = table.get(ch)
        if code is None:
            raise ValueError(f"Cannot encode symbol {ch!r} for {traits.name}")
        key = (key << bits) | code
    return key


def decode_kmer(key: int, k: int, traits: SeqTraits = DNA) -> str:
    """Decode a packed key back to text (cf. ``i2l::decode_kmer``, ``dump.cpp:23``)."""
    bits = traits.bits_per_symbol
    mask = (1 << bits) - 1
    out = []
    for i in range(k):
        code = (key >> (bits * (k - 1 - i))) & mask
        if code >= traits.alphabet_size:
            raise ValueError(f"Invalid code {code} in key {key}")
        out.append(traits.letters[code])
    return "".join(out)


def dense_index_to_key(index: np.ndarray, k: int, traits: SeqTraits) -> np.ndarray:
    """Convert base-σ dense indices (the accumulator's key space) to packed keys.

    The dense enumeration core indexes candidates in mixed-radix base σ
    (contiguous); the serialized key uses bit strides (``pk_compute.cpp:99``).
    For DNA (σ = 2^bits) the two coincide and this is the identity.
    """
    index = np.asarray(index, dtype=np.uint64)
    sigma = traits.alphabet_size
    bits = traits.bits_per_symbol
    if sigma == (1 << bits):
        return index
    key = np.zeros_like(index)
    rem = index.copy()
    for i in range(k):  # extract digits LSB-first
        digit = rem % sigma
        rem //= sigma
        key |= digit << np.uint64(bits * i)
    return key


def key_to_dense_index(key: np.ndarray, k: int, traits: SeqTraits) -> np.ndarray:
    """Inverse of :func:`dense_index_to_key`."""
    key = np.asarray(key, dtype=np.uint64)
    sigma = traits.alphabet_size
    bits = traits.bits_per_symbol
    if sigma == (1 << bits):
        return key
    mask = np.uint64((1 << bits) - 1)
    index = np.zeros_like(key)
    mult = np.uint64(1)
    for i in range(k):
        digit = (key >> np.uint64(bits * i)) & mask
        index += digit * mult
        mult *= np.uint64(sigma)
    return index
