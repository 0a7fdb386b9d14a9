"""Device times of the decode rows at chip_smoke.py phase 3's shapes, alone.

Times decode.cu's rows and ragged.cu's mixed step (decode rows beside a
256-token chunk) on bf16 and int8 pools at Phi-3's and Gemma-2's windowed
shapes (PHI3_SHAPE, GEMMA_SHAPE), and decode.cu's rows at the 8B's shape on
128- and 512-page tables, with the same inputs and timer (`device_ms`) as
phase 3, without its plain versions, library calls or other kernels: a
quick A/B of decode tile variants. Run it on the card from the root of the
tree to measure (it imports the package and `chip_smoke.py` beside it):

    python3 decode_probe.py LABEL

For a variant, copy `dynamo_tpu_torch/`, `chip_smoke.py` and this file
into a directory of their own, change the copy, and run it there: each
copy builds its own library under its own `build/`. Prints one JSON line:
{"variant": LABEL, row: [device ms, max |error| against the plain decode
for the decode rows], ..., "ptxas": the narrow decode tile's registers}.
Exits 1 without a card.
"""

import json
import sys

import torch

import chip_smoke as cs
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import cuda_attention as ca


def table_of(contexts, width: int, perm) -> torch.Tensor:
    """A [len(contexts), width] table giving each row distinct pages from
    `perm`, trash-padded (as phase 3's)."""
    table = torch.zeros((len(contexts), width), dtype=torch.int32)
    used = 0
    for b, c in enumerate(contexts):
        n = -(-c // cs.PS)
        table[b, :n] = perm[used:used + n] + 1
        used += n
    return table


def windowed_rows(dev, shape: dict) -> dict:
    """decode and ragged on bf16 and int8 pools at a windowed shape."""
    g = torch.Generator(device=dev)
    g.manual_seed(shape["seed"])
    h, kv, d = shape["h"], shape["kv"], shape["d"]
    pages, ps = shape["pool_pages"], cs.PS
    kp, vp = (torch.randn((pages, ps, kv * d), generator=g,
                          device=dev).bfloat16() for _ in range(2))
    w8 = att.kv_lane_width(kv, d, True)
    kp8, vp8 = (att.pack_kv_rows(x.reshape(-1, kv, d), w8).reshape(
        pages, ps, w8) for x in (kp, vp))
    perm = torch.randperm(pages - 1,
                          generator=torch.Generator().manual_seed(3))
    ctx = list(shape["decode_ctx"])
    table = table_of(ctx, shape["max_seq_len"] // ps, perm)
    td = table.to(dev)
    cd = torch.tensor(ctx, dtype=torch.int32, device=dev)
    q = (torch.randn((len(ctx), h, d), generator=g, device=dev)
         * shape["q_scale"]).bfloat16()
    start, c = shape["chunk_start"], cs.CHUNK
    chunk = torch.zeros(((start + c) // ps + c // ps - 1,), dtype=torch.int32)
    used = int((table > 0).sum())
    chunk[:(start + c) // ps] = perm[used:used + (start + c) // ps] + 1
    tabs, kv_lens, q_starts = att.ragged_descriptors(td, cd, chunk.to(dev),
                                                     start, c)
    qr = (torch.randn((len(ctx) + c, h, d), generator=g, device=dev)
          * shape["q_scale"]).bfloat16()
    kw = dict(window=shape["window"], logit_cap=shape["cap"], page_size=ps,
              num_kv_heads=kv)
    out = {}
    for sfx, (k, v) in {"": (kp, vp), "_int8": (kp8, vp8)}.items():
        def dec(k=k, v=v):
            return ca.paged_attention_decode(q, k, v, td, cd, **kw)
        ref = att.paged_attention_decode_ref(q, k, v, td, cd, **kw)
        err = float((dec().float() - ref.float()).abs().max())
        out[f"decode{sfx}[{shape['label']}]"] = [cs.device_ms(dec, 20), err]
        out[f"ragged{sfx}[{shape['label']}]"] = [cs.device_ms(
            lambda k=k, v=v: ca.ragged_paged_attention(
                qr, k, v, tabs, kv_lens, q_starts, num_decode=len(ctx), **kw),
            20)]
    return out


def rows_8b(dev) -> dict:
    """decode.cu's rows at the 8B's shape: phase 3's `decode` (128-page
    tables) and `decode_long` (512 pages, one row at 8192 tokens)."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    kp, vp = (torch.randn((cs.NUM_PAGES, cs.PS, cs.KV * cs.D), generator=g,
                          device=dev).bfloat16() for _ in range(2))
    perm = torch.randperm(cs.NUM_PAGES - 1,
                          generator=torch.Generator().manual_seed(1))
    out = {}
    for name, ctx, width in (
            ("decode", [0, 1, 17, 100, 255, 600, 1024, 2048], 128),
            ("decode_long", [0, 1, 100, 255, 600, 1024, 2048, 8192], 512)):
        td = table_of(ctx, width, perm).to(dev)
        cd = torch.tensor(ctx, dtype=torch.int32, device=dev)
        q = torch.randn((len(ctx), cs.H, cs.D), generator=g,
                        device=dev).bfloat16()
        out[name] = [cs.device_ms(lambda: ca.paged_attention_decode(
            q, kp, vp, td, cd, page_size=cs.PS), 20)]
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("decode_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    ca.build()
    out = {"variant": argv[0] if argv else "tree"}
    for shape in (cs.PHI3_SHAPE, cs.GEMMA_SHAPE):
        out.update(windowed_rows(dev, shape))
    out.update(rows_8b(dev))
    out["ptxas"] = {k: v for src in cs.ptxas_usage(ca.build_log).values()
                    for k, v in src.items() if "narrow" in k}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
