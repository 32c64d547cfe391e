"""Run one cell of the benchmark once, on the card:

    python3 framebench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

prints the result as one JSON line, last on standard output. The
program's caches go into build/ inside the checkout."""
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # the checkout's root, in place of this script's directory, on the
    # path; every compiler cache a kernel of the port may use (the port
    # builds its own into build/) at a fixed place inside the checkout
    sys.path[0] = root
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(root, "build", sub)

    from framebench.harness import main
    sys.exit(main(sys.argv[1:], T0))
