"""One traced run of a cell, with the card's idle time put down to the
program's spans.

    python3 perfbench/idle_by_span.py --workload <cell> --seed <n> \
        --seconds <s>

Runs the cell as ``perfbench/run.py --trace 1`` does and prints its
result line with one more key, ``idle_by_span``: the device's idle
seconds in the window by the innermost program span open at each gap's
midpoint (`harness.program_spans`), or null where the program keeps no
span log.
"""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402


def main(argv=None) -> int:
    args = run.parse(list(argv if argv is not None else sys.argv[1:])
                     + ["--trace", "1"])
    run.prepare(args)
    from harness import context, program_spans, registry

    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = registry.load_cell(bench, args.workload)
    import torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = context.Context(args, cell, T_START, device)
    result = context.run_cell(ctx)
    result["idle_by_span"] = program_spans.idle_by_span(ctx.view())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
