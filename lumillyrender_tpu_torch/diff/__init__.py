"""Differentiable rendering: `render_diff`, `film_and_grads` (on the card a
captured `TrainPlan`), `pixel_grad`."""

from .render import (
    DiffParams,
    TrainPlan,
    eager_film_and_grads,
    film_and_grads,
    params_of,
    pixel_grad,
    render_diff,
    train_plan,
)

__all__ = ["DiffParams", "TrainPlan", "eager_film_and_grads", "film_and_grads", "params_of",
           "pixel_grad", "render_diff", "train_plan"]
