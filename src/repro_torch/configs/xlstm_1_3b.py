"""xLSTM-1.3B [arXiv:2405.04517]: sLSTM + mLSTM blocks, no separate FFN."""
from ..models.common import Config

CONFIG = Config(
    name="xlstm-1.3b",
    n_layers=48, d_model=2048, n_heads=4, kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304,
    # xLSTM[7:1]: one sLSTM block per 8 (48 = 6 groups of 8)
    pattern=tuple([("mlstm", "none")] * 7 + [("slstm", "none")]),
    tie_embeddings=False,
)
