"""JSON-constrained decoding (OpenAI `response_format: {"type":
"json_object"}`): the grammar automaton, its vocab byte table and the mask.

The port's own copy of `dynamo_tpu/ops/json_guide.py` (it imports nothing
of the JAX package); keep the two in step. The numpy half is copied
unchanged: the mode constants, `transition`, `fold_bytes`, `is_complete`,
`token_mask` (all over a namespace `xp`, numpy here), `VocabTable`,
`replay`, `advance_host`, `mask_row` and `validate_json_text`; the engine
takes the first token's mask from `mask_row`. The host mirror of each
guided sequence (admission, preemption replay, readback: one fold per
emitted token) runs `transition_scalar`, the same automaton in plain
Python ints, some 500x cheaper a byte than `transition` over numpy
scalars (`advance_scalar`, `replay_scalar`).

The device half is new: `DeviceTable` (the vocab table on the card:
token_bytes uint8 [V, 16], zero-padded, token_len int32 [V], eos uint8
[V]), and the plain PyTorch versions of the two device functions,
`mask_logits` (each guided row's disallowed tokens set to -1e9, the JAX
engine's value) and `advance` (each guided row's state folded through its
sampled token). `transition_torch` writes `transition` out in torch ops
(torch has no `.astype` or `asarray(x, dtype)`) over int32 tensors, so
`1 << 31` wraps to INT_MIN as numpy's int32 does. These are the CPU path
and, on the card, the reference of the CUDA kernel in `csrc/json_mask.cu`
(`ops/cuda_guide.py` wraps it).

The grammar, as in the JAX package: a pushdown automaton whose state packs
into three int32 scalars per sequence --

  mode   : which micro-state of the grammar we are in (inside a string, an
           escape, a number, expecting a key, ...);
  depth  : container nesting depth (the PDA stack pointer);
  bits   : the PDA stack itself -- bit i says whether the container at
           depth i is an array (1) or object (0). Depth is capped at 31 so
           the stack is ONE int32.

Grammar notes:
- json_object mode: the first generated byte must open an object (`{`);
  once the object closes, ONLY an EOS/stop token is allowed (no trailing
  whitespace), so generation terminates immediately on completion.
- numbers follow the exact JSON grammar -?(0|[1-9]\\d*)(\\.\\d+)?
  ([eE][+-]?\\d+)? -- "12e", "01", "-", ".5" are rejected, so accepted
  output always survives json.loads.
- strings accept any byte >= 0x20 unescaped (UTF-8 continuation bytes
  included; byte-level structure is not validated) and the standard
  escapes plus \\uXXXX.
- tokens longer than the byte matrix width, or that decode to no bytes
  (specials), are never allowed mid-JSON; stop tokens become legal exactly
  at completion.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------- modes ---
START = 0  # expect '{' (json_object: the value IS an object)
VALUE = 1  # expect any value start (after ':' or ',' in an array)
OBJ_KEY_OR_END = 2  # just opened an object: '"' key or '}'
OBJ_KEY = 3  # after ',' in an object: '"' key only
AFTER_KEY = 4  # key string closed: expect ':'
AFTER_VALUE = 5  # value closed: ',' / container close / (depth 0) EOS
ARR_VAL_OR_END = 6  # just opened an array: value start or ']'
STR_V = 7  # inside a value string
ESC_V = 8  # after '\' in a value string
U1_V, U2_V, U3_V, U4_V = 9, 10, 11, 12  # \uXXXX hex digits (value string)
STR_K = 13  # inside a key string
ESC_K = 14
U1_K, U2_K, U3_K, U4_K = 15, 16, 17, 18
# strict JSON number: -?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?
# (json.loads rejects "12e", "-", "01", ".5" — so must the mask)
NM_MINUS = 19  # after '-': int part must follow
NM_Z = 20  # int part is exactly "0"
NM_INT = 21  # in a nonzero int part
NM_FRAC0 = 22  # after '.': at least one digit required
NM_FRAC = 23  # in the fraction digits
NM_EXP0 = 24  # after e/E: sign or digit required
NM_EXPS = 25  # after exponent sign: digit required
NM_EXP = 26  # in the exponent digits
T1, T2, T3 = 27, 28, 29  # t-rue
F1, F2, F3, F4 = 30, 31, 32, 33  # f-alse
N1, N2, N3 = 34, 35, 36  # n-ull
DEAD = 37

MAX_DEPTH = 31  # stack bits live in one int32

_ESCAPABLE = (34, 92, 47, 98, 102, 110, 114, 116)  # " \ / b f n r t


def transition(xp, mode, depth, bits, c):
    """One grammar step over byte `c`. All args are (broadcastable) int32
    arrays under namespace `xp` (numpy or jax.numpy); returns (mode',
    depth', bits'). An illegal byte lands in DEAD (and stays there)."""
    i32 = xp.int32
    mode = xp.asarray(mode, i32)
    depth = xp.asarray(depth, i32)
    bits = xp.asarray(bits, i32)
    c = xp.asarray(c, i32)

    is_ws = (c == 32) | (c == 9) | (c == 10) | (c == 13)
    is_digit = (c >= 48) & (c <= 57)
    is_d19 = (c >= 49) & (c <= 57)
    lo = c | 32
    is_hex = is_digit | ((lo >= 97) & (lo <= 102))
    is_e = (c == 101) | (c == 69)
    is_str_safe = (c >= 32) & (c != 34) & (c != 92)
    is_escapable = xp.zeros_like(c, dtype=bool)
    for e in _ESCAPABLE:
        is_escapable = is_escapable | (c == e)

    can_push = depth < MAX_DEPTH
    top_is_arr = xp.where(depth > 0, (bits >> xp.maximum(depth - 1, 0)) & 1,
                          0) == 1

    # -- shared: value start ('{' '[' '"' -digit t f n), used by VALUE /
    #    ARR_VAL_OR_END (and START restricted to '{')
    vs_push = ((c == 123) | (c == 91)) & can_push
    vs_mode = xp.where(
        (c == 123) & can_push, OBJ_KEY_OR_END,
        xp.where((c == 91) & can_push, ARR_VAL_OR_END,
                 xp.where(c == 34, STR_V,
                          xp.where(c == 45, NM_MINUS,
                                   xp.where(c == 48, NM_Z,
                                            xp.where(is_d19, NM_INT,
                                                     xp.where(c == 116, T1,
                                                              xp.where(c == 102, F1,
                                                                       xp.where(c == 110, N1,
                                                                                DEAD)))))))))
    vs_depth = depth + vs_push.astype(i32)
    pushed_bits = xp.where(c == 91, bits | (1 << depth),
                           bits & ~(1 << depth))
    vs_bits = xp.where(vs_push, pushed_bits, bits)

    # -- shared: AFTER_VALUE byte handling (also NUM's delimiter path).
    #    depth 0 means the top-level object closed: no byte is legal.
    av_pop = (((c == 125) & ~top_is_arr) | ((c == 93) & top_is_arr)) \
        & (depth > 0)
    av_mode = xp.where(
        depth == 0, DEAD,
        xp.where(is_ws, AFTER_VALUE,
                 xp.where((c == 44) & top_is_arr, VALUE,
                          xp.where((c == 44) & ~top_is_arr, OBJ_KEY,
                                   xp.where(av_pop, AFTER_VALUE, DEAD)))))
    av_depth = depth - av_pop.astype(i32)

    def str_mode(body, esc, close_to):
        return xp.where(c == 34, close_to,
                        xp.where(c == 92, esc,
                                 xp.where(is_str_safe, body, DEAD)))

    def esc_mode(body, u1):
        return xp.where(c == 117, u1,
                        xp.where(is_escapable, body, DEAD))

    def hex_mode(nxt):
        return xp.where(is_hex, nxt, DEAD)

    # number-state transitions; terminal states delegate delimiters to the
    # AFTER_VALUE handling (the byte that ends a number also closes/joins)
    def num_term(cont_mode):
        return xp.where(cont_mode != DEAD, cont_mode, av_mode)

    nm_z = num_term(xp.where(c == 46, NM_FRAC0,
                             xp.where(is_e, NM_EXP0, DEAD)))
    nm_int = num_term(xp.where(is_digit, NM_INT,
                               xp.where(c == 46, NM_FRAC0,
                                        xp.where(is_e, NM_EXP0, DEAD))))
    nm_frac = num_term(xp.where(is_digit, NM_FRAC,
                                xp.where(is_e, NM_EXP0, DEAD)))
    nm_exp = num_term(xp.where(is_digit, NM_EXP, DEAD))

    def num_depth_for(cont_mode):
        return xp.where(cont_mode != DEAD, depth, av_depth)

    nm_z_d = num_depth_for(xp.where(c == 46, NM_FRAC0,
                                    xp.where(is_e, NM_EXP0, DEAD)))
    nm_int_d = num_depth_for(xp.where(is_digit, NM_INT,
                                      xp.where(c == 46, NM_FRAC0,
                                               xp.where(is_e, NM_EXP0,
                                                        DEAD))))
    nm_frac_d = num_depth_for(xp.where(is_digit, NM_FRAC,
                                       xp.where(is_e, NM_EXP0, DEAD)))
    nm_exp_d = num_depth_for(xp.where(is_digit, NM_EXP, DEAD))

    # -- per-mode next state; selected by `mode` below
    conds = [
        mode == START,
        mode == VALUE,
        mode == OBJ_KEY_OR_END,
        mode == OBJ_KEY,
        mode == AFTER_KEY,
        mode == AFTER_VALUE,
        mode == ARR_VAL_OR_END,
        mode == STR_V,
        mode == ESC_V,
        mode == U1_V, mode == U2_V, mode == U3_V, mode == U4_V,
        mode == STR_K,
        mode == ESC_K,
        mode == U1_K, mode == U2_K, mode == U3_K, mode == U4_K,
        mode == NM_MINUS, mode == NM_Z, mode == NM_INT,
        mode == NM_FRAC0, mode == NM_FRAC,
        mode == NM_EXP0, mode == NM_EXPS, mode == NM_EXP,
        mode == T1, mode == T2, mode == T3,
        mode == F1, mode == F2, mode == F3, mode == F4,
        mode == N1, mode == N2, mode == N3,
    ]
    okoe_pop = (c == 125) & (depth > 0)
    aoe_pop = (c == 93) & (depth > 0)
    lit = lambda want, nxt: xp.where(c == want, nxt, DEAD)  # noqa: E731
    modes = [
        # START: only '{' (depth 0, can_push always true)
        xp.where(c == 123, OBJ_KEY_OR_END, DEAD),
        xp.where(is_ws, VALUE, vs_mode),
        xp.where(is_ws, OBJ_KEY_OR_END,
                 xp.where(c == 34, STR_K,
                          xp.where(okoe_pop, AFTER_VALUE, DEAD))),
        xp.where(is_ws, OBJ_KEY, xp.where(c == 34, STR_K, DEAD)),
        xp.where(is_ws, AFTER_KEY, xp.where(c == 58, VALUE, DEAD)),
        av_mode,
        xp.where(is_ws, ARR_VAL_OR_END,
                 xp.where(aoe_pop, AFTER_VALUE, vs_mode)),
        str_mode(STR_V, ESC_V, AFTER_VALUE),
        esc_mode(STR_V, U1_V),
        hex_mode(U2_V), hex_mode(U3_V), hex_mode(U4_V), hex_mode(STR_V),
        str_mode(STR_K, ESC_K, AFTER_KEY),
        esc_mode(STR_K, U1_K),
        hex_mode(U2_K), hex_mode(U3_K), hex_mode(U4_K), hex_mode(STR_K),
        xp.where(c == 48, NM_Z, xp.where(is_d19, NM_INT, DEAD)),
        nm_z,
        nm_int,
        xp.where(is_digit, NM_FRAC, DEAD),
        nm_frac,
        xp.where(is_digit, NM_EXP,
                 xp.where((c == 43) | (c == 45), NM_EXPS, DEAD)),
        xp.where(is_digit, NM_EXP, DEAD),
        nm_exp,
        lit(114, T2), lit(117, T3), lit(101, AFTER_VALUE),
        lit(97, F2), lit(108, F3), lit(115, F4), lit(101, AFTER_VALUE),
        lit(117, N2), lit(108, N3), lit(108, AFTER_VALUE),
    ]
    depths = [
        xp.where(c == 123, depth + 1, depth),
        xp.where(is_ws, depth, vs_depth),
        depth - okoe_pop.astype(i32),
        depth, depth,
        av_depth,
        xp.where(is_ws, depth,
                 xp.where(aoe_pop, depth - 1, vs_depth)),
        depth, depth, depth, depth, depth, depth,
        depth, depth, depth, depth, depth, depth,
        depth, nm_z_d, nm_int_d, depth, nm_frac_d, depth, depth, nm_exp_d,
        depth, depth, depth, depth, depth, depth, depth,
        depth, depth, depth,
    ]
    bitss = [
        bits & ~(1 << depth),  # START pushes an object at bit `depth`
        xp.where(is_ws, bits, vs_bits),
        bits, bits, bits,
        bits,  # AFTER_VALUE pops never rewrite bits (stale top bits are
        # overwritten by the next push's mask-and-set)
        xp.where(is_ws | aoe_pop, bits, vs_bits),
        bits, bits, bits, bits, bits, bits,
        bits, bits, bits, bits, bits, bits,
        bits, bits, bits, bits, bits, bits, bits, bits,
        bits, bits, bits, bits, bits, bits, bits,
        bits, bits, bits,
    ]
    nm = xp.select(conds, modes, DEAD)
    nd = xp.select(conds, depths, depth)
    nb = xp.select(conds, bitss, bits)
    # DEAD absorbs; freeze depth/bits there so state stays bounded
    nd = xp.where(nm == DEAD, depth, nd)
    nb = xp.where(nm == DEAD, bits, nb)
    return nm.astype(i32), nd.astype(i32), nb.astype(i32)


def fold_bytes(xp, mode, depth, bits, token_bytes, token_len):
    """Fold a token's byte row(s) through the automaton.

    token_bytes [..., L] int32 (pad -1), token_len [...] int32. State args
    broadcast against the leading dims. Returns (mode', depth', bits', ok)
    where ok = the whole token is legal from this state (length >= 1 and no
    step hit DEAD)."""
    L = token_bytes.shape[-1]
    m = xp.asarray(mode, xp.int32) + xp.zeros_like(token_len)
    d = xp.asarray(depth, xp.int32) + xp.zeros_like(token_len)
    b = xp.asarray(bits, xp.int32) + xp.zeros_like(token_len)
    ok = token_len > 0
    for step in range(L):
        c = token_bytes[..., step]
        live = step < token_len
        nm, nd, nb = transition(xp, m, d, b, c)
        ok = ok & (~live | (nm != DEAD))
        m = xp.where(live, nm, m)
        d = xp.where(live, nd, d)
        b = xp.where(live, nb, b)
    return m, d, b, ok


def is_complete(xp, mode, depth):
    """The generated text is one complete JSON object: only EOS may follow."""
    return (mode == AFTER_VALUE) & (depth == 0)


def token_mask(xp, mode, depth, bits, token_bytes, token_len, eos_mask):
    """Allowed-token mask over the vocab.

    mode/depth/bits: [...] per-sequence state; token_bytes [V, L] /
    token_len [V] from a vocab table; eos_mask [V] bool marks stop tokens.
    Returns [..., V] bool. Mid-JSON, a token is allowed iff all its bytes
    survive; at completion only stop tokens are allowed."""
    m = mode[..., None]
    d = depth[..., None]
    b = bits[..., None]
    _, _, _, ok = fold_bytes(xp, m, d, b, token_bytes, token_len)
    done = is_complete(xp, m, d)
    return xp.where(done, eos_mask, ok & ~eos_mask)


class VocabTable:
    """Byte decomposition of a tokenizer's vocab: token_bytes [V, L] int32
    (-1 pad), token_len [V] int32 (0 = special/unrepresentable), eos_mask
    [V] bool (stop tokens, legal only at completion)."""

    def __init__(self, token_bytes: np.ndarray, token_len: np.ndarray,
                 eos_mask: np.ndarray):
        self.token_bytes = token_bytes.astype(np.int32)
        self.token_len = token_len.astype(np.int32)
        self.eos_mask = eos_mask.astype(bool)

    @property
    def vocab_size(self) -> int:
        return self.token_bytes.shape[0]

    @staticmethod
    def for_byte_vocab(vocab_size: int,
                       eos_ids: Sequence[int]) -> "VocabTable":
        """ids < 256 are literal bytes (engine.tokenizer.ByteTokenizer);
        everything else is special."""
        tb = np.full((vocab_size, 1), -1, np.int32)
        tl = np.zeros((vocab_size,), np.int32)
        n = min(vocab_size, 256)
        tb[:n, 0] = np.arange(n)
        tl[:n] = 1
        eos = np.zeros((vocab_size,), bool)
        for i in eos_ids:
            if 0 <= i < vocab_size:
                eos[i] = True
                tl[i] = 0  # a stop token is never 'text'
        return VocabTable(tb, tl, eos)

    @staticmethod
    def for_tokenizer(tokenizer, eos_ids: Sequence[int],
                      max_len: int = 16,
                      vocab_size: Optional[int] = None) -> "VocabTable":
        """Build from any engine tokenizer (HF or byte).

        Per-token bytes come from `convert_ids_to_tokens` when available:
        SentencePiece pieces map '▁' to a real space and byte-fallback
        pieces '<0xNN>' to their byte — decode([id]) STRIPS the leading
        '▁' space marker, which previously masked '▁5' as '5' and let the
        grammar sample it mid-number, rendering '12 5' / 'tr ue' in the
        detokenized stream despite the json_object guarantee (Phi-3 and
        every other SP tokenizer). Byte-level BPE pieces (no '▁'
        convention) keep the decode([id]) path, which round-trips exactly.

        `vocab_size` sizes the table to the MODEL vocab when it differs
        from the tokenizer's (TPU-friendly padded embeddings): padding ids
        decode to nothing and are never legal mid-JSON."""
        if getattr(tokenizer, "vocab_size", 0) <= 259 and not hasattr(
                tokenizer, "tok"):
            return VocabTable.for_byte_vocab(
                vocab_size or tokenizer.vocab_size, eos_ids)
        v = vocab_size or tokenizer.vocab_size
        tb = np.full((v, max_len), -1, np.int32)
        tl = np.zeros((v,), np.int32)
        raw = getattr(tokenizer, "tok", tokenizer)
        convert = getattr(raw, "convert_ids_to_tokens", None)
        byte_piece = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")
        for i in range(min(v, tokenizer.vocab_size)):
            try:
                bs = None
                if convert is not None:
                    piece = convert(i)
                    if isinstance(piece, str):
                        m = byte_piece.match(piece)
                        if m:
                            # SP byte-fallback piece: exactly one raw byte
                            bs = bytes([int(m.group(1), 16)])
                        elif "▁" in piece:
                            # SP word-boundary marker(s) ARE spaces — the
                            # whole point of this table is byte fidelity
                            bs = piece.replace("▁", " ").encode("utf-8")
                if bs is None:
                    bs = tokenizer.decode([i]).encode("utf-8")
            except Exception:
                continue
            if 0 < len(bs) <= max_len:
                tb[i, : len(bs)] = np.frombuffer(bs, np.uint8)
                tl[i] = len(bs)
        eos = np.zeros((v,), bool)
        for i in eos_ids:
            if 0 <= i < v:
                eos[i] = True
                tl[i] = 0
        return VocabTable(tb, tl, eos)


def replay(table: VocabTable,
           tokens: Sequence[int]) -> Tuple[int, int, int]:
    """Host-side state reconstruction: fold every emitted token from START.
    Used at (re)admission — preemption-by-recompute re-derives the same
    tokens, so replaying them yields the exact mid-stream grammar state."""
    m = np.int32(START)
    d = np.int32(0)
    b = np.int32(0)
    for t in tokens:
        if 0 <= t < table.vocab_size and table.token_len[t] > 0:
            m, d, b, _ = fold_bytes(
                np, m, d, b, table.token_bytes[t], table.token_len[t])
    return int(m), int(d), int(b)


def advance_host(table: VocabTable, state: Tuple[int, int, int],
                 token: int) -> Tuple[int, int, int]:
    """Incremental host-mirror update for one emitted token."""
    m, d, b = state
    if 0 <= token < table.vocab_size and table.token_len[token] > 0:
        nm, nd, nb, _ = fold_bytes(
            np, np.int32(m), np.int32(d), np.int32(b),
            table.token_bytes[token], table.token_len[token])
        return int(nm), int(nd), int(nb)
    return m, d, b


def mask_row(table: VocabTable, mode: int, depth: int,
             bits: int) -> np.ndarray:
    """Host-side [V] allowed mask for one state (first-token masking after
    prefill, including mid-stream states after preemption replay)."""
    return token_mask(
        np,
        np.asarray(mode, np.int32).reshape(1),
        np.asarray(depth, np.int32).reshape(1),
        np.asarray(bits, np.int32).reshape(1),
        table.token_bytes, table.token_len, table.eos_mask,
    )[0]


def validate_json_text(text: str) -> bool:
    """Test oracle: does the automaton accept `text` as a complete object?
    (Pure host path — drives the fuzz comparison against json.loads.)"""
    m, d, b = np.int32(START), np.int32(0), np.int32(0)
    for c in text.encode("utf-8"):
        m, d, b = transition(np, m, d, b, np.int32(c))
        if int(m) == DEAD:
            return False
    return bool(is_complete(np, m, d))


# ------------------------------------------------------- host (scalar) ---
# `transition` over numpy scalars costs ~300 numpy calls a byte (~1 ms):
# the engine's host mirror folds every emitted token of every guided
# sequence, so it uses this plain-Python version of the same automaton
# (the structure of csrc/json_mask.cu's switch), held equal to
# `transition` over every mode and byte in the tests.

def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _bit_int(depth: int) -> int:
    """(int32)(1u << depth); 0 past bit 31, as numpy's shift gives."""
    return _i32(1 << depth) if 0 <= depth < 32 else 0


def _value_start(depth: int, bits: int, c: int) -> Tuple[int, int, int]:
    if c in (123, 91) and depth < MAX_DEPTH:
        b = _bit_int(depth)
        return ((OBJ_KEY_OR_END if c == 123 else ARR_VAL_OR_END), depth + 1,
                _i32(bits | b) if c == 91 else _i32(bits & ~b))
    m = {34: STR_V, 45: NM_MINUS, 48: NM_Z, 116: T1, 102: F1,
         110: N1}.get(c, NM_INT if 49 <= c <= 57 else DEAD)
    return m, depth, bits


def _after_value(depth: int, bits: int, c: int) -> Tuple[int, int, int]:
    if depth == 0:
        return DEAD, depth, bits
    if c in (32, 9, 10, 13):
        return AFTER_VALUE, depth, bits
    top_is_arr = (bits >> (depth - 1)) & 1 == 1
    if c == 44:
        return (VALUE if top_is_arr else OBJ_KEY), depth, bits
    if (c == 125 and not top_is_arr) or (c == 93 and top_is_arr):
        return AFTER_VALUE, depth - 1, bits
    return DEAD, depth, bits


_STRINGS = {STR_V: (STR_V, ESC_V, AFTER_VALUE), STR_K: (STR_K, ESC_K,
                                                         AFTER_KEY)}
_ESCAPES = {ESC_V: (STR_V, U1_V), ESC_K: (STR_K, U1_K)}
_HEX = {U1_V: U2_V, U2_V: U3_V, U3_V: U4_V, U4_V: STR_V,
        U1_K: U2_K, U2_K: U3_K, U3_K: U4_K, U4_K: STR_K}
_LITERALS = {T1: (114, T2), T2: (117, T3), T3: (101, AFTER_VALUE),
             F1: (97, F2), F2: (108, F3), F3: (115, F4),
             F4: (101, AFTER_VALUE), N1: (117, N2), N2: (108, N3),
             N3: (108, AFTER_VALUE)}


def _number_cont(mode: int, c: int) -> int:
    digit = 48 <= c <= 57
    e = c in (101, 69)
    if mode == NM_Z:
        return NM_FRAC0 if c == 46 else (NM_EXP0 if e else DEAD)
    if mode == NM_INT:
        return (NM_INT if digit else NM_FRAC0 if c == 46
                else NM_EXP0 if e else DEAD)
    if mode == NM_FRAC:
        return NM_FRAC if digit else (NM_EXP0 if e else DEAD)
    return NM_EXP if digit else DEAD  # NM_EXP


def transition_scalar(mode: int, depth: int, bits: int,
                      c: int) -> Tuple[int, int, int]:
    """`transition` for one state and byte, in plain Python ints."""
    ws = c in (32, 9, 10, 13)
    n = (DEAD, depth, bits)
    if mode == START:
        if c == 123:
            n = (OBJ_KEY_OR_END, depth + 1, _i32(bits & ~_bit_int(depth)))
    elif mode == VALUE:
        n = (VALUE, depth, bits) if ws else _value_start(depth, bits, c)
    elif mode == OBJ_KEY_OR_END:
        if ws:
            n = (OBJ_KEY_OR_END, depth, bits)
        elif c == 34:
            n = (STR_K, depth, bits)
        elif c == 125 and depth > 0:
            n = (AFTER_VALUE, depth - 1, bits)
    elif mode == OBJ_KEY:
        if ws or c == 34:
            n = (OBJ_KEY if ws else STR_K, depth, bits)
    elif mode == AFTER_KEY:
        if ws or c == 58:
            n = (AFTER_KEY if ws else VALUE, depth, bits)
    elif mode == AFTER_VALUE:
        n = _after_value(depth, bits, c)
    elif mode == ARR_VAL_OR_END:
        if ws:
            n = (ARR_VAL_OR_END, depth, bits)
        elif c == 93 and depth > 0:
            n = (AFTER_VALUE, depth - 1, bits)
        else:
            n = _value_start(depth, bits, c)
    elif mode in _STRINGS:
        body, esc, close_to = _STRINGS[mode]
        m = (close_to if c == 34 else esc if c == 92
             else body if c >= 32 else DEAD)
        n = (m, depth, bits)
    elif mode in _ESCAPES:
        body, u1 = _ESCAPES[mode]
        m = u1 if c == 117 else (body if c in _ESCAPABLE else DEAD)
        n = (m, depth, bits)
    elif mode in _HEX:
        lo = c | 32
        if 48 <= c <= 57 or 97 <= lo <= 102:
            n = (_HEX[mode], depth, bits)
    elif mode == NM_MINUS:
        if c == 48 or 49 <= c <= 57:
            n = (NM_Z if c == 48 else NM_INT, depth, bits)
    elif mode in (NM_Z, NM_INT, NM_FRAC, NM_EXP):
        cont = _number_cont(mode, c)
        n = (cont, depth, bits) if cont != DEAD else _after_value(
            depth, bits, c)
    elif mode == NM_FRAC0:
        if 48 <= c <= 57:
            n = (NM_FRAC, depth, bits)
    elif mode == NM_EXP0:
        if 48 <= c <= 57 or c in (43, 45):
            n = (NM_EXP if 48 <= c <= 57 else NM_EXPS, depth, bits)
    elif mode == NM_EXPS:
        if 48 <= c <= 57:
            n = (NM_EXP, depth, bits)
    elif mode in _LITERALS:
        want, nxt = _LITERALS[mode]
        if c == want:
            n = (nxt, depth, bits)
    if n[0] == DEAD:
        return DEAD, depth, bits
    return n


def advance_scalar(table: VocabTable, state: Tuple[int, int, int],
                   token: int) -> Tuple[int, int, int]:
    """`advance_host` over transition_scalar: the state after `token`'s
    bytes (unchanged for a token without bytes)."""
    if not (0 <= token < table.vocab_size) or table.token_len[token] <= 0:
        return state
    m, d, b = state
    for c in table.token_bytes[token, :table.token_len[token]].tolist():
        m, d, b = transition_scalar(m, d, b, c)
        if m == DEAD:
            break  # DEAD absorbs
    return m, d, b


def replay_scalar(table: VocabTable,
                  tokens: Sequence[int]) -> Tuple[int, int, int]:
    """`replay` over transition_scalar."""
    state = (START, 0, 0)
    for t in tokens:
        state = advance_scalar(table, state, int(t))
    return state


# ------------------------------------------------------ device (torch) ---
TABLE_WIDTH = 16  # bytes per token in the device table: for_tokenizer's
# max_len, so one row is one 16-byte load in the kernel
MASKED = -1e9  # the logit of a disallowed token (the JAX engine's value)
_M32 = (1 << 32) - 1


class DeviceTable:
    """A VocabTable on a device, in the kernel's layout: token_bytes uint8
    [V, TABLE_WIDTH] (zero past each token's length), token_len int32 [V]
    (0 for specials and stop tokens), eos uint8 [V] (1 = stop token)."""

    def __init__(self, table: VocabTable, device):
        import torch

        v, width = table.token_bytes.shape
        if width > TABLE_WIDTH:
            raise ValueError(f"vocab table rows of {width} bytes exceed the "
                             f"device table's {TABLE_WIDTH}")
        if (table.token_len > width).any() or (table.token_len < 0).any():
            raise ValueError("token_len outside [0, table width]")
        tb = np.zeros((v, TABLE_WIDTH), np.uint8)
        tb[:, :width] = np.clip(table.token_bytes, 0, 255)
        self.vocab_size = v
        self.token_bytes = torch.from_numpy(tb).to(device)
        self.token_len = torch.from_numpy(
            table.token_len.astype(np.int32)).to(device)
        self.eos = torch.from_numpy(
            table.eos_mask.astype(np.uint8)).to(device)


def _bit(depth):
    """1 << depth as int32 (bit 31 wraps to INT_MIN, as in numpy)."""
    import torch

    return torch.bitwise_left_shift(torch.ones_like(depth), depth)


def transition_torch(mode, depth, bits, c):
    """`transition` in torch ops over broadcastable int32 tensors ->
    (mode', depth', bits'), int32, equal to numpy's."""
    import torch

    i32 = torch.int32

    def sel(cond, a, b):
        return torch.where(cond, a, b)

    is_ws = (c == 32) | (c == 9) | (c == 10) | (c == 13)
    is_digit = (c >= 48) & (c <= 57)
    is_d19 = (c >= 49) & (c <= 57)
    lo = c | 32
    is_hex = is_digit | ((lo >= 97) & (lo <= 102))
    is_e = (c == 101) | (c == 69)
    is_str_safe = (c >= 32) & (c != 34) & (c != 92)
    is_escapable = torch.zeros_like(c, dtype=torch.bool)
    for e in _ESCAPABLE:
        is_escapable = is_escapable | (c == e)

    can_push = depth < MAX_DEPTH
    top_is_arr = sel(depth > 0, (bits >> (depth - 1).clamp_min(0)) & 1,
                     torch.zeros_like(bits)) == 1
    bit = _bit(depth)

    vs_push = ((c == 123) | (c == 91)) & can_push
    vs_mode = sel((c == 123) & can_push, OBJ_KEY_OR_END,
                  sel((c == 91) & can_push, ARR_VAL_OR_END,
                      sel(c == 34, STR_V, sel(c == 45, NM_MINUS,
                          sel(c == 48, NM_Z, sel(is_d19, NM_INT,
                              sel(c == 116, T1, sel(c == 102, F1,
                                  sel(c == 110, N1,
                                      torch.full_like(c, DEAD))))))))))
    vs_depth = depth + vs_push.to(i32)
    pushed_bits = sel(c == 91, bits | bit, bits & ~bit)
    vs_bits = sel(vs_push, pushed_bits, bits)

    av_pop = ((((c == 125) & ~top_is_arr) | ((c == 93) & top_is_arr))
              & (depth > 0))
    av_mode = sel(depth == 0, DEAD,
                  sel(is_ws, AFTER_VALUE,
                      sel((c == 44) & top_is_arr, VALUE,
                          sel((c == 44) & ~top_is_arr, OBJ_KEY,
                              sel(av_pop, AFTER_VALUE,
                                  torch.full_like(c, DEAD))))))
    av_depth = depth - av_pop.to(i32)
    dead = torch.full_like(c, DEAD)

    def str_mode(body, esc, close_to):
        return sel(c == 34, close_to,
                   sel(c == 92, esc, sel(is_str_safe, body, dead)))

    def esc_mode(body, u1):
        return sel(c == 117, u1, sel(is_escapable, body, dead))

    def hex_mode(nxt):
        return sel(is_hex, nxt, dead)

    def num_term(cont):
        """(mode, depth) of a number state: its continuation, else the
        byte ends the number and goes through AFTER_VALUE's handling."""
        return (sel(cont != DEAD, cont, av_mode),
                sel(cont != DEAD, depth, av_depth))

    nm_z, nm_z_d = num_term(sel(c == 46, NM_FRAC0, sel(is_e, NM_EXP0, dead)))
    nm_int, nm_int_d = num_term(
        sel(is_digit, NM_INT, sel(c == 46, NM_FRAC0,
                                  sel(is_e, NM_EXP0, dead))))
    nm_frac, nm_frac_d = num_term(
        sel(is_digit, NM_FRAC, sel(is_e, NM_EXP0, dead)))
    nm_exp, nm_exp_d = num_term(sel(is_digit, NM_EXP, dead))
    okoe_pop = (c == 125) & (depth > 0)
    aoe_pop = (c == 93) & (depth > 0)

    def lit(want, nxt):
        return sel(c == want, nxt, dead)

    # mode -> (mode', depth' or None = depth, bits' or None = bits)
    table = {
        START: (sel(c == 123, OBJ_KEY_OR_END, dead),
                sel(c == 123, depth + 1, depth), bits & ~bit),
        VALUE: (sel(is_ws, VALUE, vs_mode), sel(is_ws, depth, vs_depth),
                sel(is_ws, bits, vs_bits)),
        OBJ_KEY_OR_END: (sel(is_ws, OBJ_KEY_OR_END,
                             sel(c == 34, STR_K,
                                 sel(okoe_pop, AFTER_VALUE, dead))),
                         depth - okoe_pop.to(i32), None),
        OBJ_KEY: (sel(is_ws, OBJ_KEY, sel(c == 34, STR_K, dead)), None, None),
        AFTER_KEY: (sel(is_ws, AFTER_KEY, sel(c == 58, VALUE, dead)), None,
                    None),
        AFTER_VALUE: (av_mode, av_depth, None),
        ARR_VAL_OR_END: (sel(is_ws, ARR_VAL_OR_END,
                             sel(aoe_pop, AFTER_VALUE, vs_mode)),
                         sel(is_ws, depth, sel(aoe_pop, depth - 1, vs_depth)),
                         sel(is_ws | aoe_pop, bits, vs_bits)),
        STR_V: (str_mode(STR_V, ESC_V, AFTER_VALUE), None, None),
        ESC_V: (esc_mode(STR_V, U1_V), None, None),
        U1_V: (hex_mode(U2_V), None, None),
        U2_V: (hex_mode(U3_V), None, None),
        U3_V: (hex_mode(U4_V), None, None),
        U4_V: (hex_mode(STR_V), None, None),
        STR_K: (str_mode(STR_K, ESC_K, AFTER_KEY), None, None),
        ESC_K: (esc_mode(STR_K, U1_K), None, None),
        U1_K: (hex_mode(U2_K), None, None),
        U2_K: (hex_mode(U3_K), None, None),
        U3_K: (hex_mode(U4_K), None, None),
        U4_K: (hex_mode(STR_K), None, None),
        NM_MINUS: (sel(c == 48, NM_Z, sel(is_d19, NM_INT, dead)), None, None),
        NM_Z: (nm_z, nm_z_d, None),
        NM_INT: (nm_int, nm_int_d, None),
        NM_FRAC0: (sel(is_digit, NM_FRAC, dead), None, None),
        NM_FRAC: (nm_frac, nm_frac_d, None),
        NM_EXP0: (sel(is_digit, NM_EXP,
                      sel((c == 43) | (c == 45), NM_EXPS, dead)), None, None),
        NM_EXPS: (sel(is_digit, NM_EXP, dead), None, None),
        NM_EXP: (nm_exp, nm_exp_d, None),
        T1: (lit(114, T2), None, None),
        T2: (lit(117, T3), None, None),
        T3: (lit(101, AFTER_VALUE), None, None),
        F1: (lit(97, F2), None, None),
        F2: (lit(108, F3), None, None),
        F3: (lit(115, F4), None, None),
        F4: (lit(101, AFTER_VALUE), None, None),
        N1: (lit(117, N2), None, None),
        N2: (lit(108, N3), None, None),
        N3: (lit(108, AFTER_VALUE), None, None),
    }
    shape = torch.broadcast_shapes(mode.shape, depth.shape, bits.shape,
                                   c.shape)
    nm = torch.full(shape, DEAD, dtype=i32, device=c.device)
    nd = depth.expand(shape).to(i32)
    nb = bits.expand(shape).to(i32)
    for m, (m2, d2, b2) in table.items():
        at = mode == m
        nm = sel(at, m2.to(i32), nm)
        if d2 is not None:
            nd = sel(at, d2.to(i32), nd)
        if b2 is not None:
            nb = sel(at, b2.to(i32), nb)
    # DEAD absorbs; depth and bits freeze there
    nd = sel(nm == DEAD, depth.to(i32), nd)
    nb = sel(nm == DEAD, bits.to(i32), nb)
    return nm, nd, nb


def fold_torch(mode, depth, bits, token_bytes, token_len):
    """`fold_bytes` in torch ops: token_bytes [..., L] (any int type; past
    token_len unread), token_len [...] int32, state broadcasting against
    the leading dims -> (mode', depth', bits', ok)."""
    import torch

    zero = torch.zeros_like(token_len, dtype=torch.int32)
    m, d, b = mode + zero, depth + zero, bits + zero
    ok = token_len > 0
    for step in range(token_bytes.shape[-1]):
        live = step < token_len
        if not bool(live.any()):
            break
        nm, nd, nb = transition_torch(m, d, b,
                                      token_bytes[..., step].to(torch.int32))
        ok = ok & (~live | (nm != DEAD))
        m = torch.where(live, nm, m)
        d = torch.where(live, nd, d)
        b = torch.where(live, nb, b)
    return m, d, b, ok


def token_mask_torch(mode, depth, bits, table: DeviceTable):
    """`token_mask` in torch ops over rows of state [B] -> [B, V] bool
    allowed tokens."""
    m, d, b = mode[:, None], depth[:, None], bits[:, None]
    _, _, _, ok = fold_torch(m, d, b, table.token_bytes, table.token_len)
    eos = table.eos.bool()
    done = (m == AFTER_VALUE) & (d == 0)
    return (done & eos) | (~done & ok & ~eos)


def mask_logits(logits, mode, depth, bits, active, table: DeviceTable):
    """The plain version of the `json_mask` kernel: in place, logits
    [B, V] of each row with active [B] set get MASKED wherever the row's
    state (mode, depth, bits [B] int32) allows no token."""
    allowed = token_mask_torch(mode, depth, bits, table)
    logits.masked_fill_(active.bool()[:, None] & ~allowed, MASKED)
    return logits


def advance(tokens, mode, depth, bits, active, table: DeviceTable) -> None:
    """The plain version of the `json_advance` kernel: in place, each
    active row's state folds the bytes of its sampled token tokens [B]."""
    import torch

    tok = tokens.long().clamp(0, table.vocab_size - 1)
    m, d, b, _ = fold_torch(mode, depth, bits, table.token_bytes[tok],
                            table.token_len[tok])
    act = active.bool()
    mode.copy_(torch.where(act, m, mode))
    depth.copy_(torch.where(act, d, depth))
    bits.copy_(torch.where(act, b, bits))
