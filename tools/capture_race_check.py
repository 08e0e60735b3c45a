"""CUDA graph captures against pinned host allocations on another thread.

The streaming scorer's prep workers take pinned host buffers
(``pipeline.BufferPool``) while the consumer captures a bucket's program
as a CUDA graph (``scoring.ScoringEngine._capture``). This check captures
a small program 300 times on the main thread, after an eager warm-up on
a side stream, while a second thread allocates and frees pinned host
tensors (``pin``) or does nothing (``none``), in one capture mode
(``global``, ``thread_local`` or ``relaxed``), and prints how many
captures failed. It needs a CUDA device:

    for c in none pin; do for m in global thread_local relaxed; do
        python3 tools/capture_race_check.py $c $m; done; done
"""
import sys
import threading

import torch


def main(churn_kind, mode):
    dev = torch.device("cuda")
    x = torch.randn(4096, 256, device=dev)
    w = torch.randn(256, 256, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            (x @ w).relu() @ w
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    stop = threading.Event()
    errors = []

    def churn():
        i = 0
        while not stop.is_set():
            try:
                t = torch.empty((1 << 12) + (i % 97) * 4096, pin_memory=True)
                t.numpy()[:1] = 1
                del t
            except Exception as e:  # lint: broad-except — counted
                errors.append(type(e).__name__)
            i += 1

    if churn_kind == "pin":
        th = threading.Thread(target=churn, name="pinned-churn",
                              daemon=True)
        th.start()
    fails, first = 0, None
    for k in range(300):
        g = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        try:
            with torch.cuda.graph(g, capture_error_mode=mode):
                (x @ w).relu() @ w
            g.replay()
        except Exception as e:  # lint: broad-except — counted
            fails += 1
            if first is None:
                first = k
            last = f"{type(e).__name__}: {str(e)[:90]}"
    stop.set()
    print(f"churn {churn_kind}, capture mode {mode}: {fails} of 300 captures "
          f"failed (first at {first}); churn errors {len(errors)}"
          + (f"; last: {last}" if fails else ""))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
