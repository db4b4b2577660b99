"""How the reference multiplies: in float32, or, as the control, with both
operands rounded to float8 (e4m3) first, the step below bfloat16 that a
faster program might take. The control's scales are per tensor for weights
and per row for activations, as float8 inference keeps them."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


class Float32:
    name = "float32"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return w.float()

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
        """x [..., in] @ w [in, out] (+ b)."""
        y = self.act(x) @ self.weight(w)
        return y if b is None else y + b.float()

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.act(a) @ self.act(b.transpose(-1, -2)).transpose(-1, -2)


class Float8(Float32):
    name = "float8_e4m3"

    @staticmethod
    def _round(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
        """x with its values rounded to float8; a gradient passes through
        unchanged."""
        x = x.float()
        with torch.no_grad():
            scale = (amax.float() / E4M3_MAX).clamp(min=1e-12)
            q = (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach()

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return self._round(w, w.float().abs().amax())

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self._round(x, x.float().abs().amax(dim=-1, keepdim=True))


def by_name(name: str):
    return {"float32": Float32, "float8_e4m3": Float8}[name]()
