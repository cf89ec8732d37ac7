"""The four assigned input shapes."""
from repro_torch.configs.base import InputShape

TRAIN_4K = InputShape(name="train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = InputShape(name="prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = InputShape(name="decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = InputShape(name="long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
