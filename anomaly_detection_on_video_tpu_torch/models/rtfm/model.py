"""RTFM (Robust Temporal Feature Magnitude learning, Tian et al., ICCV
2021) scorer in PyTorch.

Counterpart of the JAX package's ``models/rtfm/model.py``. Module and
parameter names are the official release's (``Aggregate.conv_1.0`` ...
``Aggregate.conv_5.0``, ``Aggregate.non_local.{theta,phi,g,W.0}``,
``fc1``-``fc3``; every Sequential holds just its conv), the layout the JAX
package's ``export_rtfm_state_dict`` writes; official checkpoints whose
branches carry a BatchNorm load through ``utils.convert.
rtfm_state_dict_from_official``, which folds it.

The multi-scale temporal network ("Aggregate") runs channels first,
``(batch, channels, clips)``: three dilated k3 convs (dilations 1/2/4,
channels -> channels/4 each) and a non-local attention branch over a
bias-free 1x1 projection, fused by a k3 conv with a residual; then a
scoring MLP (ReLU and dropout after each hidden layer) and a sigmoid. The
input is the framework's ``(bs, ncrops, t, channels + 1)`` bags, whose
magnitude channel is sliced off. With ``length``, padded-bucket scoring
equals an unpadded run on the valid prefix: pads are zeroed before every
conv and in the attention's values, and the attention divides by the true
length.

Training (``outputs``): BCE on the mean score of each bag's top-k clips by
crop-averaged feature magnitude, plus the magnitude separation (abnormal
top-k magnitudes pushed past ``margin``, normal ones pulled to zero, weight
``alpha``), temporal smoothness, and the sparsity term on the first
(normal) half of the batch, as the JAX model computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ...losses import bce_loss, smoothness_loss, sparsity_loss
from ..common import clip_masks, dropout, resolve_train
from .config import RTFMConfig


@dataclasses.dataclass
class RTFMOutput:
    loss: Optional[torch.Tensor]
    abnormal_scores: torch.Tensor  # (n_abnormal, 1) mean top-k score
    normal_scores: torch.Tensor  # (n_normal, 1)
    scores: torch.Tensor  # (bs, t, 1) crop-averaged clip scores


class NonLocal1D(nn.Module):
    """Embedded-Gaussian non-local block over the clip axis, mean
    normalized: ``W((theta^T phi / n) g^T) + x``, where n is the true
    length when given, else the clip count."""

    def __init__(self, in_channels: int, inter_channels: int):
        super().__init__()
        self.theta = nn.Conv1d(in_channels, inter_channels, 1)
        self.phi = nn.Conv1d(in_channels, inter_channels, 1)
        self.g = nn.Conv1d(in_channels, inter_channels, 1)
        self.W = nn.Sequential(nn.Conv1d(inter_channels, in_channels, 1))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                denom: Optional[torch.Tensor] = None) -> torch.Tensor:
        g = self.g(x)
        if mask is not None:
            g = g * mask  # padded keys leave the (linear) attention sum
        attn = torch.einsum("bci,bcj->bij", self.theta(x), self.phi(x))
        attn = attn / (x.shape[-1] if denom is None else denom.reshape(-1, 1, 1))
        return self.W(torch.einsum("bij,bcj->bci", attn, g)) + x


class Aggregate(nn.Module):
    """Dilated temporal pyramid + non-local branch, fused, residual."""

    def __init__(self, channels: int):
        super().__init__()
        branch = channels // 4

        def dilated(d: int) -> nn.Sequential:
            # flax's SAME padding of a k3 conv with dilation d
            return nn.Sequential(nn.Conv1d(channels, branch, 3, dilation=d, padding=d))

        self.conv_1 = dilated(1)
        self.conv_2 = dilated(2)
        self.conv_3 = dilated(4)
        self.conv_4 = nn.Sequential(nn.Conv1d(channels, branch, 1, bias=False))
        self.conv_5 = nn.Sequential(nn.Conv1d(4 * branch, channels, 3, padding=1))
        self.non_local = NonLocal1D(branch, branch // 2)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                denom: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is not None:
            x = x * mask  # zeros past the boundary reproduce the convs' zero padding
        y1 = torch.relu(self.conv_1(x))
        y2 = torch.relu(self.conv_2(x))
        y3 = torch.relu(self.conv_3(x))
        z = self.conv_4(x)
        if mask is not None:
            z = z * mask
        z = self.non_local(z, mask, denom)
        out = torch.cat([y1, y2, y3, z], dim=1)
        if mask is not None:
            out = out * mask  # before the k3 fuse conv
        return torch.relu(self.conv_5(out)) + x


class RTFM(nn.Module):
    def __init__(self, config: RTFMConfig = RTFMConfig()):
        super().__init__()
        self.config = config
        hidden = config.hidden_dims
        self.Aggregate = Aggregate(config.channels)
        self.fc1 = nn.Linear(config.channels, hidden[0])
        self.fc2 = nn.Linear(hidden[0], hidden[1])
        self.fc3 = nn.Linear(hidden[1], 1)

    def forward(self, video: torch.Tensor, length: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``video`` (bs, ncrops, t, channels [+ 1]) -> scores (bs, t, 1);
        ``length`` (a scalar or (bs,)) masks a padded clip axis; pads
        score 0."""
        return self._head(video, length, 0.0, None)[0]

    def _head(self, video, length, rate, generator, shard=None):
        """-> (crop-averaged scores (bs, t, 1), crop-averaged feature
        magnitudes (bs, t), padded clips at -1)."""
        cfg = self.config
        bs, ncrops, t, fdim = video.shape
        if fdim > cfg.channels:
            video = video[..., : cfg.channels]  # drop the magnitude channel
        x = video.reshape(bs * ncrops, t, cfg.channels).transpose(1, 2)  # (B, C, T)
        video_mask, row_mask = clip_masks(length, t, ncrops, video.device)
        mask = denom = None
        if row_mask is not None:
            mask = row_mask[:, None].to(x.dtype)  # (1|B, 1, t)
            length = torch.as_tensor(length, device=video.device)
            denom = length if length.dim() == 0 else length.repeat_interleave(ncrops)
        features = self.Aggregate(x, mask, denom).transpose(1, 2)  # (B, T, C)
        h = dropout(torch.relu(self.fc1(features)), rate, generator, shard)
        h = dropout(torch.relu(self.fc2(h)), rate, generator, shard)
        scores = torch.sigmoid(self.fc3(h)).reshape(bs, ncrops, t).mean(dim=1)[..., None]
        magnitudes = torch.linalg.vector_norm(features, dim=2).reshape(bs, ncrops, t).mean(dim=1)
        if video_mask is not None:
            scores = scores * video_mask[..., None]
            magnitudes = torch.where(video_mask, magnitudes, -1.0)  # pads never win the top-k
        return scores, magnitudes

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
    ) -> RTFMOutput:
        """The JAX ``RTFMForVideoAnomalyDetection`` outputs. ``train`` is
        the module's mode (passing it only checks that it agrees); in train
        mode the head's two dropouts draw their masks from ``generator``
        (needed when ``config.dropout_rate > 0``) and the batch splits into
        its normal and abnormal halves, as with ``force_split``. With both
        label vectors the loss is computed.

        ``shard`` (a ``parallel.DataShard``): ``video`` is this rank's
        contiguous slice of the batch; its scores and magnitudes are
        gathered with autograd (the dropout masks drawn at the whole batch's
        shape), so every rank computes the single-device outputs and loss."""
        cfg = self.config
        train = resolve_train(self, train)
        scores, magnitudes = self._head(video, length, cfg.dropout_rate if train else 0.0,
                                        generator, shard)
        if shard is not None:
            scores, magnitudes = shard.gather(scores), shard.gather(magnitudes)
        bs = scores.shape[0]
        if force_split or train:
            half = bs // 2
            n_mag, a_mag = magnitudes[:half], magnitudes[half:]
            n_scores, a_scores = scores[:half], scores[half:]
        else:
            n_mag = a_mag = magnitudes
            n_scores = a_scores = scores

        def topk_by_magnitude(mag, sc):
            top = torch.topk(mag, cfg.k, dim=1)
            top_scores = torch.gather(sc, 1, top.indices[:, :, None])
            return top.values.mean(dim=1), top_scores.mean(dim=1)  # (n,), (n, 1)

        a_top_mag, score_abnormal = topk_by_magnitude(a_mag, a_scores)
        n_top_mag, score_normal = topk_by_magnitude(n_mag, n_scores)
        loss = None
        if abnormal_labels is not None and normal_labels is not None:
            labels = torch.cat([normal_labels, abnormal_labels])
            loss_cls = bce_loss(torch.cat([score_normal, score_abnormal]).squeeze(), labels)
            # magnitude separation (RTFM eq. 4-6)
            loss_abn = torch.mean(torch.clamp(cfg.margin - a_top_mag, min=0.0) ** 2)
            loss_nor = torch.mean(n_top_mag ** 2)
            loss = (loss_cls + cfg.alpha * (loss_abn + loss_nor)
                    + smoothness_loss(scores, cfg.smoothness_lambda)
                    + sparsity_loss(scores[: bs // 2].reshape(-1), cfg.sparsity_lambda))
        return RTFMOutput(loss=loss, abnormal_scores=score_abnormal, normal_scores=score_normal,
                          scores=scores)
