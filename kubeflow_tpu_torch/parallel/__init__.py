"""Sequence parallelism for long contexts: ring attention (``ring``) and
Ulysses all-to-all attention with its ring composition (``ulysses``), on
``torch.distributed`` process groups."""
