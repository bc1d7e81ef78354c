"""xLSTM-1.3B [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks.

xLSTM[7:1]: 7 mLSTM blocks per sLSTM block; 4 heads; no separate FFN
(d_ff=0) — projection factors live inside the blocks (mLSTM pf=2, sLSTM
pf=4/3 post-MLP).  O(1) recurrent state ⇒ long_500k runs (state cache, no
KV cache).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm",
                   "mlstm", "slstm"),
    pos="none", sub_quadratic=True, source="arXiv:2405.04517")
