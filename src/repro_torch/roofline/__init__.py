"""The roofline of a step: per-device counts (``counts``, on ``meta`` over a
fake ``torch.distributed`` world or on the card) and the three-term
roofline on a ``Hardware`` (``analysis``). Counterpart of
``repro/roofline``."""
