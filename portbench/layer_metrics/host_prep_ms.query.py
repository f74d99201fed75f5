"""Host prep of a query batch: the benchmark's spans around the program's
query tokenizer (``text/processor``) and ``HybridSearchEngine.stage_inputs``
(the heavy pair table, ``gather_rows.group_pairs``, the tail chunk table
and their uploads), in ms a batch over the traced run's window."""


def read(readings):
    if not readings.get("batches"):
        return None
    return readings["host_prep_s"] / readings["batches"] * 1e3
