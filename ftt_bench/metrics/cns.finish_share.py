"""The finisher's time in DeviceCns.finish_chunk_dp / finish_chunk (fetch,
then host assembly or host MSA) over the window."""
from ftt_bench import readers


def read(run):
    return readers.span_share(run, "cns.finish")
