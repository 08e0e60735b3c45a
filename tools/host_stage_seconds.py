"""Seconds of each host stage of the rich-DSL paths, on this machine's CPU.

Trains the every-surface workflow and the taggers workflow of
``transmogrifai_tpu_torch.every_surface`` at ``--n`` records (one LR grid
point, on the CPU), then transforms the training store once more stage by
stage and prints each stage's transform seconds and their linear
extrapolation to ``--scale`` records (default 200,000): the figure that
decides which path a stage's rows are cut for. With ``--w2v-pairs`` it
instead counts the skip-gram pairs Word2Vec would train on over the
subjects and over the bodies of ``--scale`` records (the figure behind
training it on the subjects).

    python tools/host_stage_seconds.py --n 2000
    python tools/host_stage_seconds.py --w2v-pairs
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from transmogrifai_tpu_torch import every_surface as ES  # noqa: E402


def stage_seconds(out):
    model, store = out["model"], out["store"]
    acc = store
    rows = []
    for layer in model._resolved_dag():
        for m in layer:
            kw = {"device": "cpu"} if getattr(m, "uses_device", False) else {}
            t0 = time.perf_counter()
            acc = m.transform(acc, **kw)
            rows.append((time.perf_counter() - t0, type(m).__name__,
                         getattr(m, "operation_name", "")))
    return rows


def w2v_pairs(n):
    from transmogrifai_tpu_torch import Workflow
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops.topics import (W2V_CHUNK_BYTES,
                                                    OpWord2Vec,
                                                    w2v_chunk_pairs)
    store = ES.raw_store(ES.make_raw(n))
    toks = [FeatureBuilder.Text(c).from_column().as_predictor().tokenize()
            for c in ("subject", "body")]
    out = Workflow().set_input_store(store).set_result_features(
        *toks).train(device="cpu").transform(store, device="cpu",
                                              engine=False)
    w2v = OpWord2Vec()
    for col, f in zip(("subject", "body"), toks):
        vocab, counts, _, centers, _ = w2v.pairs(out[f.name].values)
        P, V, S, D = len(centers), len(vocab), w2v.neg_samples, w2v.dim
        chunk = w2v_chunk_pairs(S, D, V, 4, W2V_CHUNK_BYTES)
        print(f"{col}: {n} records, {sum(counts.values())} tokens, V {V}, "
              f"{P} pairs; [P, S, D] gather {P * S * D * 4:,} bytes in "
              f"f32; {chunk} pairs a chunk")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--scale", type=int, default=200_000)
    ap.add_argument("--w2v-pairs", action="store_true")
    args = ap.parse_args()
    if args.w2v_pairs:
        return w2v_pairs(args.scale)
    for name, out in (
            ("every-surface", ES.run(ES.make_raw(args.n), device="cpu",
                                     families=ES.one_point_families()[:1])),
            ("taggers", ES.run_taggers(ES.make_tagger_raw(args.n),
                                       device="cpu"))):
        print(f"{name}: {args.n} records, train {out['train_s']:.2f} s")
        for s, cls, op in sorted(stage_seconds(out), reverse=True):
            print(f"  {cls:34s} {op:28s} {s:9.4f} s  "
                  f"x{args.scale // args.n}: {s * args.scale / args.n:8.1f} s")


if __name__ == "__main__":
    main()
