"""Sultani MIL ranking scorer (Sultani et al., CVPR 2018) in PyTorch.

Counterpart of the JAX package's ``models/sultani/model.py``. Parameter
names are the common pytorch-port layout (``fc1``, ``fc2``, ``fc3``), so the
JAX package's ``export_sultani_state_dict`` output loads with
``load_state_dict``. A per-segment MLP channels -> 512 (ReLU, dropout) ->
32 (linear, dropout) -> 1 (sigmoid), crop-averaged; the input is the
framework's ``(bs, ncrops, t, channels + 1)`` bags, whose magnitude channel
is sliced off.

Training (``outputs``): the batch is the normal bags then the abnormal
ones, row i of each half a pair; the loss is the paper's eq. 3 per pair,
``max(0, 1 - max_i f(A_i) + max_i f(N_i))`` plus smoothness
``λ1·Σ(f(A_{i+1}) - f(A_i))²`` and sparsity ``λ2·Σ f(A_i)`` on the abnormal
bag, averaged over the pairs. The paper's L2 weight term comes from the
optimizer's weight decay, not the loss.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..common import clip_masks, dropout, resolve_train
from .config import SultaniConfig


@dataclasses.dataclass
class SultaniOutput:
    loss: Optional[torch.Tensor]
    abnormal_scores: torch.Tensor  # (n_abnormal, 1) per-pair abnormal segment-score max
    normal_scores: torch.Tensor  # (n_normal, 1)
    scores: torch.Tensor  # (bs, t, 1) crop-averaged segment scores


class Sultani(nn.Module):
    def __init__(self, config: SultaniConfig = SultaniConfig()):
        super().__init__()
        self.config = config
        hidden = config.hidden_dims
        self.fc1 = nn.Linear(config.channels, hidden[0])
        self.fc2 = nn.Linear(hidden[0], hidden[1])
        self.fc3 = nn.Linear(hidden[1], 1)

    def forward(self, video: torch.Tensor, length: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``video`` (bs, ncrops, t, channels [+ 1]) -> scores (bs, t, 1);
        ``length`` (a scalar or (bs,)) zeroes the padded clips' scores."""
        return self._scores(video, length, 0.0, None)

    def _scores(self, video, length, rate, generator, shard=None) -> torch.Tensor:
        cfg = self.config
        bs, ncrops, t, fdim = video.shape
        if fdim > cfg.channels:
            video = video[..., : cfg.channels]  # drop the magnitude channel
        x = video.reshape(bs * ncrops, t, cfg.channels)
        # the official topology: the 32-d layer has no activation
        h = dropout(torch.relu(self.fc1(x)), rate, generator, shard)
        h = dropout(self.fc2(h), rate, generator, shard)
        scores = torch.sigmoid(self.fc3(h)).reshape(bs, ncrops, t).mean(dim=1)[..., None]
        video_mask, _ = clip_masks(length, t, ncrops, video.device)
        if video_mask is not None:
            scores = scores * video_mask[..., None]
        return scores

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
    ) -> SultaniOutput:
        """The JAX ``SultaniForVideoAnomalyDetection`` outputs. ``train`` is
        the module's mode (passing it only checks that it agrees); in train
        mode both dropouts draw their masks from ``generator`` (needed when
        ``config.dropout_rate > 0``) and the batch splits into its normal
        and abnormal halves, as with ``force_split``. With both label
        vectors the ranking loss is computed.

        ``shard`` (a ``parallel.DataShard``): ``video`` is this rank's
        contiguous slice of the batch; its scores are gathered with autograd
        (the dropout masks drawn at the whole batch's shape), so every rank
        computes the single-device outputs and loss."""
        cfg = self.config
        train = resolve_train(self, train)
        scores = self._scores(video, length, cfg.dropout_rate if train else 0.0, generator, shard)
        if shard is not None:
            scores = shard.gather(scores)
        if force_split or train:
            half = scores.shape[0] // 2
            n_scores, a_scores = scores[:half], scores[half:]
        else:
            n_scores = a_scores = scores
        a_max = a_scores[:, :, 0].max(dim=1).values
        n_max = n_scores[:, :, 0].max(dim=1).values
        loss = None
        if abnormal_labels is not None and normal_labels is not None:
            hinge = torch.relu(1.0 - a_max + n_max)
            a = a_scores[:, :, 0]
            smooth = torch.sum((a[:, 1:] - a[:, :-1]) ** 2, dim=1)
            sparse = torch.sum(a, dim=1)
            loss = torch.mean(hinge + cfg.smoothness_lambda * smooth + cfg.sparsity_lambda * sparse)
        return SultaniOutput(loss=loss, abnormal_scores=a_max[:, None],
                             normal_scores=n_max[:, None], scores=scores)
