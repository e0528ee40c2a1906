"""MGFN (Magnitude-Glance-Focus Network) scorer, eval path, in PyTorch.

Counterpart of the JAX package's ``models/mgfn/model.py``. Module and
parameter names are the reference's HF MGFN names
(``backbone.amplifier.to_tokens``, ``backbone.layers.{s}.{b}.scc``,
``.attention.{norm,to_qkv,to_v,rel_pos,to_out}``,
``.ffn.{layer_norm,in_conv,out_conv}``, intermediates at
``backbone.layers.{s}.{depth}.{layer_norm,conv}``, ``layer_norm``, ``fc``),
so the JAX package's ``export_mgfn_state_dict`` output or a reference
checkpoint loads with ``load_state_dict``.

Sequences run channels first, ``(batch, channels, clips)``, the layout of
torch's Conv1d; the public input is the JAX package's
``(bs, ncrops, clips, channels + 1)`` and the output its ``scores``
``(bs, clips, 1)``. ``length`` enables padded-bucket scoring: pads are
zeroed before every temporal conv and excluded from attention, so the
scores of the valid prefix equal an unpadded run.

Training (``MGFN.outputs``, the JAX ``MGFNForVideoAnomalyDetection``
outputs): in train mode ``TorchBatchNorm`` normalizes with batch statistics
and updates its running ones, every feed-forward block drops at
``MGFNConfig.dropout`` after its GELU, the normal and abnormal halves of the batch
each take a dropout-masked top-k selection of clips by feature magnitude
(``_selection_indices``), and the MIL loss (``losses/``) is computed from
the selected scores and features.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...losses import mgfn_loss, smoothness_loss, sparsity_loss
from ..common import clip_masks, dropout, resolve_train
from .config import MGFNConfig


@dataclasses.dataclass
class MGFNOutput:
    loss: Optional[torch.Tensor]
    abnormal_scores: torch.Tensor  # (n_abnormal, 1) mean top-k score
    normal_scores: torch.Tensor  # (n_normal, 1)
    a_feat_magnitude: torch.Tensor  # (ncrops * n_abnormal, k, dim) selected features
    n_feat_magnitude: torch.Tensor  # (ncrops * n_normal, k, dim)
    scores: torch.Tensor  # (bs, t, 1) crop-averaged clip scores


class ChannelLayerNorm(nn.Module):
    """The reference MGFNLayerNorm: normalizes over channels with biased
    variance and eps added to the std, (x - mean) / (std + eps) * g + b;
    g and b stored as (1, dim, 1)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, dim, 1))
        self.b = nn.Parameter(torch.zeros(1, dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        std = torch.sqrt(x.var(dim=1, unbiased=False, keepdim=True))
        return (x - mean) / (std + self.eps) * self.g + self.b


class TorchBatchNorm(nn.BatchNorm1d):
    """BatchNorm1d with the JAX ``TorchBatchNorm``'s arithmetic:
    (x - mean) * rsqrt(var + eps) * weight + bias over (batch, clips) per
    channel. In eval mode mean and var are the running statistics. In train
    mode they are the batch's, with the biased variance, and the running
    statistics move by momentum 0.1 towards the batch mean and the unbiased
    variance, in their own dtype.

    The batch statistics are sums: the per-channel sum, then the sum of
    squared deviations from the mean, each accumulated in at least float32.
    With ``shard`` (a ``parallel.DataShard``, ``x`` this rank's bags) both
    sums are reduced over the data axis with autograd, so every rank
    normalizes by the whole batch's mean and variance, moves its running
    statistics with the whole batch's count, and the gradients are those of
    one device."""

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        view = (1, -1, 1)
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps).view(view)
            return (x - self.running_mean.view(view)) * inv * self.weight.view(view) + self.bias.view(view)
        acc = torch.promote_types(x.dtype, torch.float32)
        n = x.numel() // x.shape[1]
        total = x.sum(dim=(0, 2), dtype=acc)
        if shard is not None:
            total = shard.all_reduce(total)
            n *= shard.count
        mean = total / n
        squares = ((x.to(acc) - mean.view(view)) ** 2).sum(dim=(0, 2))
        if shard is not None:
            squares = shard.all_reduce(squares)
        var = squares / n
        with torch.no_grad():
            m = self.momentum
            unbiased = (var * (n / max(n - 1, 1))).to(self.running_var.dtype)
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean.to(self.running_mean.dtype))
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        inv = torch.rsqrt(var + self.eps).view(view)
        return (x - mean.view(view)) * inv * self.weight.view(view) + self.bias.view(view)


class FeedForward(nn.Module):
    """Conv-MLP: channel LayerNorm, 1x1 conv up, exact GELU, dropout, 1x1
    conv down. In train mode the GELU's output goes through
    ``common.dropout`` at rate ``self.dropout`` (flax's ``nn.Dropout`` after
    the JAX model's GELU, its mask from ``generator``); in eval mode nothing
    is dropped."""

    def __init__(self, dim: int, repe: int = 4, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.layer_norm = ChannelLayerNorm(dim)
        self.in_conv = nn.Conv1d(dim, dim * repe, 1)
        self.out_conv = nn.Conv1d(dim * repe, dim, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                shard=None) -> torch.Tensor:
        x = F.gelu(self.in_conv(self.layer_norm(x)))
        if self.training:
            x = dropout(x, self.dropout, generator, shard)
        return self.out_conv(x)


class FeatureAmplifier(nn.Module):
    """Splits features and magnitude, k3 conv on each, x_f + ratio * x_m."""

    def __init__(self, config: MGFNConfig):
        super().__init__()
        self.channels = config.channels
        self.mag_ratio = config.mag_ratio
        self.to_tokens = nn.Conv1d(config.channels, config.dims[0], 3, padding=1)
        self.to_mag = nn.Conv1d(1, config.dims[0], 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_f, x_m = x[:, : self.channels], x[:, self.channels:]
        return self.to_tokens(x_f) + self.mag_ratio * self.to_mag(x_m)


class GlanceAttention(nn.Module):
    """Full self-attention over clips; padded keys masked with the dtype's
    most negative finite value, as the JAX package masks them."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        self.norm = ChannelLayerNorm(dim)
        self.to_qkv = nn.Conv1d(dim, inner * 3, 1, bias=False)
        self.to_out = nn.Conv1d(inner, dim, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                shard=None) -> torch.Tensor:
        b, _, t = x.shape
        q, k, v = self.to_qkv(self.norm(x)).chunk(3, dim=1)
        # channel index h * dim_head + d ("(h d)")
        split = lambda a: a.reshape(b, self.heads, self.dim_head, t)
        q, k, v = split(q) * (self.dim_head ** -0.5), split(k), split(v)
        acc = torch.promote_types(q.dtype, torch.float32)  # float32 logits under bfloat16
        sim = torch.einsum("bhdi,bhdj->bhij", q.to(acc), k.to(acc))
        if mask is not None:
            key_mask = mask[:, 0][:, None, None, :] > 0  # (1|B, 1, 1, T)
            sim = torch.where(key_mask, sim, torch.finfo(sim.dtype).min)
        attn = sim.softmax(dim=-1).to(v.dtype)
        out = torch.einsum("bhij,bhdj->bhdi", attn, v)
        return self.to_out(out.reshape(b, self.heads * self.dim_head, t))


class FocusAttention(nn.Module):
    """BatchNorm, value projection, per-head depthwise k5 conv over clips.

    The value channels are ordered "(c h)": channel index c * heads + h,
    the reference's rearrange ``b (c h) t -> (b c) h t``.
    """

    def __init__(self, dim: int, heads: int, dim_head: int, local_aggr_kernel: int):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        self.norm = TorchBatchNorm(dim)
        self.to_v = nn.Conv1d(dim, inner, 1, bias=False)
        self.rel_pos = nn.Conv1d(heads, heads, local_aggr_kernel,
                                 padding=local_aggr_kernel // 2, groups=heads)
        self.to_out = nn.Conv1d(inner, dim, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                shard=None) -> torch.Tensor:
        b, _, t = x.shape
        v = self.to_v(self.norm(x, shard))
        if mask is not None:
            # zero pads so the k5 conv sees the zeros of an unpadded boundary
            v = v * mask
        v = self.rel_pos(v.reshape(b * self.dim_head, self.heads, t))
        return self.to_out(v.reshape(b, self.dim_head * self.heads, t))


class _Block(nn.Module):
    def __init__(self, attention: nn.Module, dim: int, config: MGFNConfig):
        super().__init__()
        self.scc = nn.Conv1d(dim, dim, 3, padding=1)
        self.attention = attention
        self.ffn = FeedForward(dim, config.ff_repe, config.dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, shard=None) -> torch.Tensor:
        if mask is not None:
            x = x * mask  # zero pads before the k3 shortcut conv
        x = self.scc(x) + x
        x = self.attention(x, mask, shard) + x
        return self.ffn(x, generator, shard) + x


class GlanceBlock(_Block):
    def __init__(self, config: MGFNConfig, dim: int, heads: int):
        super().__init__(GlanceAttention(dim, heads, config.dim_head), dim, config)


class FocusBlock(_Block):
    def __init__(self, config: MGFNConfig, dim: int, heads: int):
        super().__init__(
            FocusAttention(dim, heads, config.dim_head, config.local_aggr_kernel), dim, config)


class Intermediate(nn.Module):
    """Stage-boundary dim changer: channel LayerNorm + 1x1 conv."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.layer_norm = ChannelLayerNorm(in_dim)
        self.conv = nn.Conv1d(in_dim, out_dim, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, shard=None) -> torch.Tensor:
        return self.conv(self.layer_norm(x))


class MGFNModel(nn.Module):
    """Backbone: amplifier + staged glance/focus blocks, channels first."""

    def __init__(self, config: MGFNConfig):
        super().__init__()
        self.amplifier = FeatureAmplifier(config)
        self.layers = nn.ModuleList()
        for stage, (depth, kind) in enumerate(zip(config.depths, config.mgfn_types)):
            dim = config.dims[stage]
            heads = dim // config.dim_head
            block_cls = GlanceBlock if kind == "gb" else FocusBlock
            blocks = [block_cls(config, dim, heads) for _ in range(depth)]
            if stage != len(config.depths) - 1:
                blocks.append(Intermediate(dim, config.dims[stage + 1]))
            self.layers.append(nn.ModuleList(blocks))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, shard=None) -> torch.Tensor:
        """``generator`` feeds the feed-forward dropout masks in train mode,
        drawn in module order (stage by stage, block by block); ``shard``
        (a ``parallel.DataShard``) makes the masks and the BatchNorm
        statistics those of the whole batch."""
        if mask is not None:
            x = x * mask  # zero pads before the k3 amplifier convs
        x = self.amplifier(x)
        for blocks in self.layers:
            for block in blocks:
                x = block(x, mask, generator, shard)
        return x


class MGFN(nn.Module):
    """MGFN backbone + scoring head (LayerNorm, Linear, sigmoid), with the
    crop-averaged clip scores as output (``forward``) and the training
    outputs and loss (``outputs``)."""

    def __init__(self, config: MGFNConfig = MGFNConfig()):
        super().__init__()
        self.config = config
        self.backbone = MGFNModel(config)
        self.layer_norm = nn.LayerNorm(config.dims[-1], eps=1e-5)
        self.fc = nn.Linear(config.dims[-1], 1)

    def forward(self, video: torch.Tensor, length: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``video`` (bs, ncrops, t, channels + 1) -> scores (bs, t, 1).

        ``length``: a scalar or a (bs,) vector of valid clip counts when
        the clip axis is padded to a bucket; pads score 0.
        """
        return self._head(video, length)[1]

    def _head(self, video: torch.Tensor, length: Optional[torch.Tensor],
              generator: Optional[torch.Generator] = None, shard=None):
        """-> (head features (bs*ncrops, t, dim), crop-averaged scores
        (bs, t, 1), crop-averaged feature magnitudes (bs, t))."""
        bs, ncrops, t, c = video.shape
        x = video.reshape(bs * ncrops, t, c).transpose(1, 2)  # (B, C, T)
        video_mask, row_mask = clip_masks(length, t, ncrops, video.device)
        mask = None if row_mask is None else row_mask[:, None].to(x.dtype)  # (1|B, 1, t)
        x = self.layer_norm(self.backbone(x, mask, generator, shard).transpose(1, 2))  # (B, T, C)
        scores = torch.sigmoid(self.fc(x))  # (bs*ncrops, t, 1)
        scores = scores.reshape(bs, ncrops, t).mean(dim=1)[..., None]
        magnitudes = torch.linalg.vector_norm(x, dim=2).reshape(bs, ncrops, t).mean(dim=1)
        if video_mask is not None:
            scores = scores * video_mask[..., None]
            # padded clips never win the top-k selection
            magnitudes = torch.where(video_mask, magnitudes, -1.0)
        return x, scores, magnitudes

    def outputs(
        self,
        video: torch.Tensor,
        abnormal_labels: Optional[torch.Tensor] = None,
        normal_labels: Optional[torch.Tensor] = None,
        train: Optional[bool] = None,
        force_split: bool = False,
        length: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        shard=None,
    ) -> MGFNOutput:
        """The JAX ``MGFNForVideoAnomalyDetection`` outputs.

        ``train`` is the module's mode (``.train()`` / ``.eval()``); passing
        it only checks that it agrees. In train mode (or with
        ``force_split``) the first half of the batch is the normal bags and
        the second the abnormal ones (the runner's normal-first order), and
        each half selects its top-k clips by feature magnitude under a
        dropout mask drawn from ``generator`` (abnormal first, then normal;
        needed when ``config.dropout_rate > 0``). In train mode with
        ``config.dropout > 0`` every feed-forward block draws its dropout
        mask from ``generator`` too, in module order and before the
        selection masks. With both label vectors the MIL loss is computed:
        ``mgfn_loss`` + smoothness + sparsity.

        ``shard`` (a ``parallel.DataShard``): ``video`` is this rank's
        contiguous slice of the batch. Each rank runs the per-bag network on
        its bags; the scores and magnitudes are gathered, every rank draws
        the selection masks and picks the clips of the whole batch, each
        rank gathers its bags' selected features, and those are gathered
        too, so every rank computes the single-device outputs and loss.
        """
        train = resolve_train(self, train)
        cfg = self.config
        ncrops = video.shape[1]
        x, scores, magnitudes = self._head(video, length, generator, shard)
        if shard is not None:
            scores = shard.gather(scores)
            magnitudes = shard.gather_detached(magnitudes)  # feeds the top-k indices only
        bs = scores.shape[0]
        split = force_split or train
        half = bs // 2 if split else 0
        halves = {"abnormal": (half, bs - half), "normal": (0, half if split else bs)}  # (start, count)
        rate = cfg.dropout_rate if train else 0.0
        picked = {}
        for name in ("abnormal", "normal"):  # the selection masks' draw order
            start, count = halves[name]
            idx = _selection_indices(magnitudes[start:start + count], cfg.k, rate, generator)
            top = torch.gather(scores[start:start + count], 1, idx[:, :, None]).mean(dim=1)
            picked[name] = (idx, top)

        def selected(name):
            """(count * ncrops, k, dim) crop-major features of a half."""
            start, count = halves[name]
            idx = picked[name][0]
            if shard is None:
                return _crop_major(_take(x[start * ncrops:(start + count) * ncrops], idx, ncrops))
            rows = idx.new_zeros((bs, idx.shape[1]))
            rows[start:start + count] = idx
            local = _take(x, shard.local(rows), ncrops)
            return _crop_major(shard.gather(local)[start:start + count])

        a_selected, n_selected = selected("abnormal"), selected("normal")
        score_abnormal, score_normal = picked["abnormal"][1], picked["normal"][1]
        loss = None
        if abnormal_labels is not None and normal_labels is not None:
            loss = (mgfn_loss(score_abnormal, score_normal, a_selected, n_selected,
                              abnormal_labels, normal_labels)
                    + smoothness_loss(scores)
                    + sparsity_loss(scores[: bs // 2].reshape(-1)))
        return MGFNOutput(loss=loss, abnormal_scores=score_abnormal, normal_scores=score_normal,
                          a_feat_magnitude=a_selected, n_feat_magnitude=n_selected, scores=scores)


def _selection_indices(magnitudes: torch.Tensor, k: int, dropout_rate: float,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """(n, t) magnitudes -> (n, k) clip indices: top-k of the magnitudes
    times a keep mask scaled by 1 / (1 - rate)."""
    n, t = magnitudes.shape
    masked = magnitudes
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("the selection dropout needs an explicit torch.Generator")
        keep = torch.rand((n, t), generator=generator, device=magnitudes.device) < 1.0 - dropout_rate
        masked = magnitudes * (keep.to(magnitudes.dtype) / (1.0 - dropout_rate))
    return torch.topk(masked, k, dim=1).indices


def _take(features: torch.Tensor, idx: torch.Tensor, ncrops: int) -> torch.Tensor:
    """(n * ncrops, t, dim) sample-major features at (n, k) clip indices,
    the same for every crop of a sample -> (n, ncrops, k, dim)."""
    n, k = idx.shape
    feats = features.reshape(n, ncrops, features.shape[1], -1)
    return torch.gather(feats, 2, idx[:, None, :, None].expand(n, ncrops, k, feats.shape[-1]))


def _crop_major(selected: torch.Tensor) -> torch.Tensor:
    """(n, ncrops, k, dim) -> (ncrops * n, k, dim): row crop * n + i is
    sample i's crop."""
    n, ncrops, k, _ = selected.shape
    return selected.transpose(0, 1).reshape(ncrops * n, k, -1)


def _magnitude_selection(
    magnitudes: torch.Tensor,  # (n, t)
    features: torch.Tensor,  # (n * ncrops, t, dim), crop-major per sample
    scores: torch.Tensor,  # (n, t, 1)
    k: int,
    ncrops: int,
    dropout_rate: float,
    generator: Optional[torch.Generator],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropout-masked top-k selection of clips by feature magnitude, the
    JAX ``_magnitude_selection``: clip indices by top-k of the magnitudes
    times a keep mask scaled by 1 / (1 - rate), the same indices for every
    crop of a sample. Returns (selected features (ncrops * n, k, dim),
    crop-major: row crop * n + i is sample i's crop; mean selected score
    (n, 1))."""
    idx = _selection_indices(magnitudes, k, dropout_rate, generator)
    top_scores = torch.gather(scores, 1, idx[:, :, None])
    return _crop_major(_take(features, idx, ncrops)), top_scores.mean(dim=1)
