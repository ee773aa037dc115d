"""Differentiable rendering: `render_diff`, `film_and_grads`, `pixel_grad`."""

from .render import DiffParams, film_and_grads, params_of, pixel_grad, render_diff

__all__ = ["DiffParams", "film_and_grads", "params_of", "pixel_grad", "render_diff"]
