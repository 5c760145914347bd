"""``ServeSession``: prefill, decode and generate over one set of params and
KV caches (``repro.api.serve``).

Params come from an explicit dict (for instance ``params_from_numpy`` of a
reference ``lm_init`` pytree) or from a fresh seeded ``lm_init``.  The
session runs on ``ServeConfig.device``, which is ``"cuda"`` unless the
caller asks for ``"cpu"``; with no card present a CUDA session refuses to
start rather than run on the CPU.  Loading from a checkpoint waits for the
port's checkpoint module.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..launch.steps import make_decode_step, make_prefill_step
from ..models import init_decode_caches, lm_init, working_params
from ..models.config import ModelConfig
from .config import ConfigError, _check_arch

__all__ = ["ServeConfig", "ServeSession"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """One serving session: architecture, batch geometry, cache policy, device."""

    arch: Union[str, ModelConfig]
    smoke: bool = False
    batch: int = 4
    max_len: int = 1024                # KV-cache capacity
    use_window: bool = False           # sliding-window decode
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.batch < 1:
            raise ConfigError(f"batch={self.batch} < 1")
        if self.max_len < 1:
            raise ConfigError(f"max_len={self.max_len} < 1")
        _check_arch(self.arch)

    @property
    def model_config(self) -> ModelConfig:
        if isinstance(self.arch, ModelConfig):
            return self.arch
        from ..configs import get_config
        cfg = get_config(self.arch)
        return cfg.smoke() if self.smoke else cfg


class ServeSession:
    """Prefill/decode over one set of params and caches."""

    def __init__(self, config: ServeConfig):
        self.config = config
        self.cfg = config.model_config
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeSession: no CUDA device is available; pass "
                               "device='cpu' to run the plain versions on the CPU")
        self.params: Optional[dict] = None     # f32 masters
        self._work: Optional[dict] = None      # matmul operands in cfg.dtype
        self.caches: Optional[list] = None
        self.position = 0                      # next decode position
        self.prefill_fn = make_prefill_step(self.cfg)
        self.decode_fn = make_decode_step(self.cfg, use_window=config.use_window)

    @classmethod
    def create(cls, config: ServeConfig, params: Optional[dict] = None) -> "ServeSession":
        """Live session over ``params`` (which must lie on ``config.device``),
        or over a fresh ``lm_init`` seeded from ``config.seed``."""
        s = cls(config)
        if params is None:
            gen = torch.Generator(device=s.device).manual_seed(config.seed)
            params = lm_init(gen, s.cfg, s.device)
        s.params = params
        s._work = working_params(params, s.cfg.dtype)
        s.reset()
        return s

    def reset(self):
        """Fresh KV caches (a new batch of sequences); position rewinds.  The
        caches take the model's compute dtype (bf16 at full width, f32 under
        smoke), as the reference's default cache dtype does."""
        self.caches = init_decode_caches(
            self.cfg, self.config.batch, self.config.max_len,
            dtype=self.cfg.dtype, device=self.device)
        self.position = 0

    def prefill(self, batch: dict) -> torch.Tensor:
        """Run the prompt ``batch["tokens"]`` [B, S] through the model from
        position 0, filling the caches.  Returns the logits of the last
        prompt position, [B, 1, V] f32."""
        if self.params is None:
            raise ConfigError("session has no params; use ServeSession.create")
        S = batch["tokens"].shape[1]
        if S > self.config.max_len:
            raise ValueError(f"prompt length {S} > max_len {self.config.max_len}")
        logits, self.caches = self.prefill_fn(self._work, batch, self.caches)
        self.position = S
        return logits

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step of tokens [B, 1] at the session's current
        position; advances it.  Returns logits [B, 1, V] f32."""
        if self.position >= self.config.max_len:
            raise ValueError(f"cache full: position {self.position} = max_len")
        logits, self.caches = self.decode_fn(self._work, tokens, self.caches,
                                             self.position)
        self.position += 1
        return logits

    def generate(self, prompts: dict, gen_len: int, temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 prompt_logits: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill then sample ``gen_len`` tokens autoregressively; returns
        them as [B, gen_len] on the session's device.  ``generator``
        defaults to one on the session's device seeded from
        ``config.seed``.  ``prompt_logits`` skips the prefill (the caller
        already ran it on this session's caches) and samples the first
        token from them."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        logits = self.prefill(prompts) if prompt_logits is None else prompt_logits

        def sample(lg):
            probs = torch.softmax(lg[:, 0] / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)   # [B, 1]

        tok = sample(logits)
        out = [tok]
        for _ in range(gen_len - 1):
            tok = sample(self.decode(tok))
            out.append(tok)
        return torch.cat(out, dim=1)
