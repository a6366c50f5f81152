"""Parallelism on ``torch.distributed`` process groups: the (data, model)
mesh and the tensor-parallel pieces (``mesh``), process worlds
(``launch``), sequence parallelism for long contexts (ring attention,
``ring``; Ulysses all-to-all attention and its ring composition,
``ulysses``), expert parallelism (``moe``), and the pipeline schedule
(``pipeline``)."""
