"""CLIP text encoder (OpenCLIP ViT-H text tower of SD-2.1), port of
`models/clip_text.py`.

Pre-LN transformer with causal dense attention (plain torch: the sequence
is 2 tokens on the eval path, so there is no kernel to write) and exact
GELU.  Returns the final-layer-normed last hidden state.  `state_dict` keys
are the transformers `CLIPTextModel` keys without the `text_model.` prefix
(`checkpoint.py` strips it, as the JAX loader does).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from diffews_tpu_torch.configs import CLIPTextConfig
from diffews_tpu_torch.models.layers import LayerNorm, gelu


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class _SelfAttention(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        hd = c // self.heads
        q = self.q_proj(x).reshape(b, s, self.heads, hd)
        k = self.k_proj(x).reshape(b, s, self.heads, hd)
        v = self.v_proj(x).reshape(b, s, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits * (hd ** -0.5) + causal_bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, c)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, c: int, inter: int):
        super().__init__()
        self.fc1 = nn.Linear(c, inter)
        self.fc2 = nn.Linear(inter, c)


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.layer_norm1 = LayerNorm(c, cfg.layer_norm_eps)
        self.self_attn = _SelfAttention(c, cfg.num_attention_heads)
        self.layer_norm2 = LayerNorm(c, cfg.layer_norm_eps)
        self.mlp = _MLP(c, cfg.intermediate_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [_Layer(cfg) for _ in range(cfg.num_hidden_layers)])


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: (B, S) int -> last hidden state (B, S, hidden)."""
        b, s = input_ids.shape
        emb = self.embeddings
        # ids clamp into the vocabulary like the JAX package's gather does
        # (the tiny test config's bos/eos ids lie past its 1000 tokens)
        ids = input_ids.clamp(0, emb.token_embedding.num_embeddings - 1)
        x = emb.token_embedding.weight[ids]
        x = x + emb.position_embedding.weight[:s][None]
        causal = torch.triu(torch.full((s, s), float("-inf"), device=x.device),
                            diagonal=1)[None, None]
        for layer in self.encoder.layers:
            x = x + layer.self_attn(layer.layer_norm1(x), causal)
            h = layer.mlp.fc1(layer.layer_norm2(x))
            h = gelu(h) if self.cfg.hidden_act == "gelu" else torch.sigmoid(1.702 * h) * h
            x = x + layer.mlp.fc2(h)
        return self.final_layer_norm(x)


def empty_prompt_ids(cfg: CLIPTextConfig, pad_to: Optional[int] = None,
                     device=None) -> torch.Tensor:
    """Token ids of the empty prompt: [bos, eos] (eval protocol), or padded
    with token 0 to `pad_to` (the training ids)."""
    ids = [cfg.bos_token_id, cfg.eos_token_id]
    if pad_to is not None:
        ids = ids + [0] * (pad_to - len(ids))
    return torch.tensor([ids], dtype=torch.int64, device=device)
