"""Host prep of a query batch from the program's own regions: every
``text/process_query`` (the query tokenizer, once a query) and
``search/stage_inputs`` (the pair and chunk tables and their uploads), in
ms a batch over the traced batches; the twin of ``host_prep_ms.query``."""

from portbench.harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.get("profile"), ("text/process_query", "search/stage_inputs"))
