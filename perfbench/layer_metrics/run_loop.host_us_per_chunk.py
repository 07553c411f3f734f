"""run_loop.host_us_per_chunk: all the host does for one chunk of
`engine.run_ticks`' loop, by the program's spans
(`harness.program_spans`): ``chunk_inputs`` (the draws, the copy to the
card, the chunk's masks) and ``run_chunk`` (argument packing and the
launch), over the number of chunks.  Against the kernel's time a chunk,
it says how near the host is to pacing the card."""
from harness import program_spans


def read(view):
    spans = program_spans.spans(view)
    if spans is None:
        return None
    chunks = sum(1 for s in spans.values() if s.name == "run_chunk")
    if not chunks:
        return None
    host = sum(s.end - s.start for s in spans.values()
               if s.name in ("chunk_inputs", "run_chunk"))
    return 1e-3 * host / chunks
