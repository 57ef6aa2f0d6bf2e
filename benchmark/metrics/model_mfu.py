"""The model's products (every linear layer and both attention products,
2 operations each; counts.py) × images answered in the traced window ÷ its
seconds ÷ the card's int8 peak, in %."""

from benchmark.readers import model_mfu


def read(ctx):
    return model_mfu(ctx)
