"""Forward online-softmax attention (causal/windowed GQA), ``ops``."""
