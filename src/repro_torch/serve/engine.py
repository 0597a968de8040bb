"""Batched serving engine: prefill + decode with continuous batching and an
error-bounded compressed-KV option (the paper's technique at serving time),
in PyTorch.

The engine drives a registered arch through its ``decode_step``:
  * prefill scans ``decode_step`` over the prompt, as the JAX package does;
  * greedy or temperature sampling (an explicit ``torch.Generator``);
  * **continuous batching**: a fixed number of slots; finished slots are
    refilled from the pending-request queue without stopping the others;
  * **compressed KV** (``kv_tau``): after prefill, each slot's KV cache goes
    through the bounded quantizer (``runtime.kvcache``, the quantize kernel
    on CUDA) with a per-token l2 guarantee, and decode attends the
    compressed cache;
  * **modality frontends**: a request's ``frontend`` payloads (the VLM's
    ``{"vision_embeds": (N_vision, D)}``, whisper's
    ``{"frames": (n_frames, D)}``) go to ``init_decode_state`` by name;
    admitting a whisper request runs its encoder.

The engine runs on ``device``, the card unless the caller passes
``device="cpu"``; the params must live there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.exec import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.registry import get_model
from repro_torch.runtime.kvcache import quantize_kv_bounded

Tensor = torch.Tensor


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (S,) int32
    max_new_tokens: int
    # modality frontend payloads (stubs, as in the JAX package): VLM
    # requests carry precomputed patch embeddings, whisper's frame embeddings
    frontend: Optional[dict] = None   # e.g. {"vision_embeds": (N, d)}


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray             # generated ids
    prompt_len: int


class ServeEngine:
    def __init__(self, cfg: ModelConfig, run: RunConfig, params: Any, *,
                 batch_size: int, max_len: int, temperature: float = 0.0,
                 kv_tau: Optional[float] = None, seed: int = 0, device=None):
        self.cfg, self.run, self.params = cfg, run, params
        self.batch = batch_size
        self.max_len = max_len
        self.temperature = temperature
        self.kv_tau = kv_tau
        self.device = resolve_device(device)
        self.api = get_model(cfg)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _decode(self, token: Tensor, state):
        return self.api.decode_step(self.params, self.cfg, self.run, token,
                                    state)

    def prefill(self, tokens: Tensor, state):
        """Scan ``decode_step`` over the prompt tokens (B, S); returns the
        state and the last position's logits (B, V)."""
        logits = None
        for t in range(tokens.shape[1]):
            out, state = self._decode(tokens[:, t:t + 1], state)
            logits = out[:, 0]
        return state, logits

    def _compress_kv(self, node):
        """Bounded KV quantization of every ``KVCache`` in the state (the
        dense family's stacked caches, the VLM's self-layer caches, the
        hybrid's attention-layer ring buffers, whisper's decoder caches),
        found through its named tuples and dicts; a state with none (an
        SSM's) is returned as it is.  The cross K/V (the VLM's
        ``vision_kv``, whisper's ``cross_kv``, plain tuples) stay raw, as
        the JAX engine visits only ``KVCache`` nodes.  It recurses as a method:
        a nested recursive function would make a reference cycle through
        ``self`` that keeps the engine and its params alive until the
        cyclic garbage collector runs."""
        if isinstance(node, attn_mod.KVCache):
            return dataclasses.replace(
                node, k=quantize_kv_bounded(node.k, self.kv_tau),
                v=quantize_kv_bounded(node.v, self.kv_tau))
        if isinstance(node, dict):
            new = {key: self._compress_kv(v) for key, v in node.items()}
            same = all(new[key] is node[key] for key in node)
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            new = type(node)(*(self._compress_kv(v) for v in node))
            same = all(a is b for a, b in zip(new, node))
        else:
            return node
        return node if same else new

    def _sample(self, logits: Tensor) -> Tensor:
        logits = logits[..., :self.cfg.vocab]
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.to(torch.float32) / self.temperature, -1)
        return torch.multinomial(probs, 1, generator=self._gen)[..., 0] \
            .to(torch.int32)

    def _start(self, prompts: np.ndarray, frontend: Optional[dict]):
        """Prefill ``prompts`` (B, S) with the batched ``frontend`` payloads
        (each (B, ...)); returns the state and the first sampled tokens."""
        extra = {k: torch.as_tensor(np.asarray(v), device=self.device)
                 for k, v in (frontend or {}).items()}
        state = self.api.init_decode_state(self.params, self.cfg, self.run,
                                           prompts.shape[0], self.max_len,
                                           **extra)
        tokens = torch.as_tensor(prompts, dtype=torch.long, device=self.device)
        state, logits = self.prefill(tokens, state)
        if self.kv_tau is not None:
            state = self._compress_kv(state)
        return state, self._sample(logits)

    # -- batch generation ----------------------------------------------------
    def generate_batch(self, prompts: np.ndarray, max_new: int,
                       frontend: Optional[dict] = None) -> np.ndarray:
        """Same-length batched generation. prompts: (B, S) -> (B, max_new).
        ``frontend``: batched modality payloads, e.g.
        {"vision_embeds": (B, N, D)} or {"frames": (B, F, D)}."""
        state, tok = self._start(prompts, frontend)
        out = np.zeros((prompts.shape[0], max_new), np.int32)
        for t in range(max_new):
            out[:, t] = tok.cpu().numpy()
            logits, state = self._decode(tok[:, None].long(), state)
            tok = self._sample(logits[:, 0])
        return out

    # -- continuous batching over a request queue -----------------------------
    def serve(self, requests: list[Request]) -> list[Completion]:
        """Continuous batching: fixed slot count, finished slots refilled.
        Prompts are left-truncated to the engine max_len budget."""
        pending = list(reversed(requests))          # pop() = FIFO
        slots: list[Optional[dict]] = [None] * self.batch
        done: list[Completion] = []

        def admit(i: int) -> None:
            if not pending:
                slots[i] = None
                return
            req = pending.pop()
            state, tok = self._start(
                req.prompt[-self.max_len // 2:][None, :],
                {k: np.asarray(v)[None] for k, v in
                 (req.frontend or {}).items()})
            slots[i] = {"req": req, "state": state, "out": [], "tok": tok}

        for i in range(self.batch):
            admit(i)
        while any(s is not None for s in slots):
            for i, s in enumerate(slots):
                if s is None:
                    continue
                s["out"].append(int(s["tok"][0]))
                if len(s["out"]) >= s["req"].max_new_tokens:
                    done.append(Completion(
                        rid=s["req"].rid,
                        tokens=np.asarray(s["out"], np.int32),
                        prompt_len=len(s["req"].prompt)))
                    admit(i)
                    continue
                logits, s["state"] = self._decode(s["tok"][:, None].long(),
                                                  s["state"])
                s["tok"] = self._sample(logits[:, 0])
        return sorted(done, key=lambda c: c.rid)
