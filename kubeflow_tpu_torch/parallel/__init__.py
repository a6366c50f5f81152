"""Parallelism on ``torch.distributed`` process groups: the (data, model)
mesh (``mesh``), sequence parallelism for long contexts (ring attention,
``ring``; Ulysses all-to-all attention and its ring composition,
``ulysses``), and expert parallelism (``moe``)."""
