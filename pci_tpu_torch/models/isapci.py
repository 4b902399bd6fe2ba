"""ISAPCInet and PointINet2 (counterparts of ``pci_tpu/models/isapci.py``
``ISAPCInet`` and ``PointINet2`` with the flow frozen).  ISAPCInet:
4*field FlowNet3D flows over the window (each distinct frame encoded
once), Tnet time weighting (or none: ``use_tnet=False``, the reference's
noT_96 variant), PointNet++ feature abstraction and a point
transformer over the 2*field*N-point flow cloud, flow regression, linear
warp, adaptive attentive fusion.

In train mode the flows are computed as at eval (FlowNet3D stays in eval
mode with its running statistics, under ``torch.no_grad()``: the JAX
model's ``flow_train = train and not freeze_flow`` with ``freeze_flow``
set, and its ``stop_gradient``), and everything after them trains:
random FPS starts in PointNet++, the trainable attention, the fusion's
residual kNN and its BatchNorms on batch statistics.

Both of the JAX module's deliberate deviations from its reference are
kept: the stacked flows become one cloud by CHUNK concatenation along the
point axis, and the transformer's output folds chunk-major into channels
(``[B, 2f*N, C] -> [B, N, 2f*C]``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.fusion import PointsFusion, PointsFusionMulti
from ..nn.heads import Outputer, Tnet, Wnet
from ..nn.pointnet2 import Pointnet2FeatureAbstract
from ..nn.transformer import TransformerLayer
from .flownet3d import FlowNet3D
from .pointinet import PointINet


def flow_pair_plan(field: int):
    """The flow fan-out (copy of ``pci_tpu/models/isapci.py:_flow_pair_plan``):
    (forward_pairs, backward_pairs), each a list of ``(src_kind, src_idx,
    dst_kind, dst_idx, scale)`` with kind ``"f"`` (forward frames), ``"b"``
    (backward frames) or ``"k"`` (the key pair)."""
    fwd, bwd = [], []
    for i in reversed(range(1, field + 1)):
        fwd.append(("f", i - 1, "k", 0, 1.0 / i))
        bwd.append(("b", i - 1, "k", 1, 1.0 / i))
    fwd.append(("k", 0, "k", 1, 1.0))
    bwd.append(("k", 1, "k", 0, 1.0))
    for i in range(1, field):
        fwd.append(("k", 0, "b", i - 1, 1.0 / (i + 1)))
        bwd.append(("k", 1, "f", i - 1, 1.0 / (i + 1)))
    return fwd, bwd


class ISAPCInet(nn.Module):
    """ISAPCInet with the flow frozen (the JAX model's
    ``freeze_flow=True``); submodule names are the flax module's.  The
    reference's published variants are widths and this switch:
    ``use_tnet=False`` builds no ``tnet_forward`` / ``tnet_backward`` and
    sends the flows into PointNet++ unweighted (``New_Models0_noT_96.py``,
    at ``ff_out_c = tr_out_c = 96``); ``New_Models_field_{0,1}.py`` run
    ``field`` 0 and 1 at 128.  field 0 has no Tnet either way.
    ``fusion_k`` (32) and ``fusion_sampling`` (``"random"`` | ``"fps"``) set
    the fusion's neighbours and each warped cloud's order, as the JAX
    model's fields of those names; neither adds a parameter."""

    def __init__(self, field: int, ff_out_c: int = 64, tr_out_c: int = 64,
                 use_tnet: bool = True, fusion_k: int = 32, fusion_sampling: str = "random"):
        super().__init__()
        self.field, self.ff_out_c = field, ff_out_c
        self.use_tnet, self.fusion_k = use_tnet, fusion_k
        self.flow = FlowNet3D()
        if field >= 1 and use_tnet:
            self.tnet_forward = Tnet(field)
            self.tnet_backward = Tnet(field)
        self.ffab = Pointnet2FeatureAbstract(ff_out_c)
        self.flow_tr_forward = TransformerLayer(ff_out_c, tr_out_c, 16)
        self.flow_tr_backward = TransformerLayer(ff_out_c, tr_out_c, 16)
        self.outputer = Outputer(ff_out_c * max(2 * field, 1))
        self.fusion = PointsFusion(fusion_sampling)
        self.train()  # the frozen flow starts in eval mode too

    def train(self, mode: bool = True):
        """Train mode for everything but the frozen flow, which stays in
        eval mode (running statistics, FPS start 0)."""
        super().train(mode)
        self.flow.eval()
        return self

    def window_flows(self, forward_pcds, key_pcds, backward_pcds, ini_feature):
        """The flow candidates ``(flows_fwd, flows_bwd)``, each ``[B, C, N,
        3]`` with ``C = max(2 * field, 1)``.  field >= 1: the 4*field
        scaled flows, each distinct frame encoded once (``FlowNet3D.multi``:
        6 encodings and 8 decodes at field=2); field 0: the key pair's two
        flows."""
        if self.field == 0:
            f12, f21 = self.flow.bidirectional(key_pcds[0], key_pcds[1],
                                               ini_feature, ini_feature)
            return f12[:, None], f21[:, None]
        frames = {"f": forward_pcds, "b": backward_pcds, "k": key_pcds}
        fwd_plan, bwd_plan = flow_pair_plan(self.field)
        plan = fwd_plan + bwd_plan
        uniq: list = []
        for p in plan:
            for kid in ((p[0], p[1]), (p[2], p[3])):
                if kid not in uniq:
                    uniq.append(kid)
        pairs = [(uniq.index((p[0], p[1])), uniq.index((p[2], p[3]))) for p in plan]
        fl = self.flow.multi([frames[kind][i] for kind, i in uniq],
                             [ini_feature] * len(uniq), pairs)
        flows = torch.stack([f * p[4] for f, p in zip(fl, plan)])  # [4f, B, N, 3]
        n2f = 2 * self.field
        return flows[:n2f].movedim(0, 1), flows[n2f:].movedim(0, 1)

    def from_flows(self, flows_fwd, flows_bwd, key_pcds, t, perms=None,
                   generator: torch.Generator | None = None, momentum: float = 0.1):
        """Everything after the flows: Tnet weighting (none without Tnet or
        at field 0), the flows as one
        ``C*N``-point cloud (Tnet-weighted into PointNet++, unweighted into
        the transformer), the chunk-major fold ``[B, C*N, ch] -> [B, N,
        C*ch]``, Outputer, warp and fusion -> ``[B, N, 3]``.  In training
        ``generator`` also draws PointNet++'s FPS starts, and ``momentum``
        is the fusion's BatchNorm momentum."""
        B, C, N, _ = flows_fwd.shape
        t32 = t.float()
        if self.field >= 1 and self.use_tnet:
            weighted_fwd = flows_fwd * self.tnet_forward(t32[:, None])[:, :, None, None]
            weighted_bwd = flows_bwd * self.tnet_backward(t32[:, None])[:, :, None, None]
        else:
            weighted_fwd, weighted_bwd = flows_fwd, flows_bwd
        nets = []
        for weighted, flows, tr in ((weighted_fwd, flows_fwd, self.flow_tr_forward),
                                    (weighted_bwd, flows_bwd, self.flow_tr_backward)):
            feats = self.ffab(weighted.reshape(B, C * N, 3), generator)
            r, _ = tr(flows.reshape(B, C * N, 3), feats)
            r = r.reshape(B, C, N, self.ff_out_c).movedim(1, 2).reshape(B, N, C * self.ff_out_c)
            nets.append(self.outputer(r))
        tb = t32[:, None, None]
        warped_fwd = key_pcds[0] + nets[0] * tb
        warped_bwd = key_pcds[1] + nets[1] * (1.0 - tb)
        return self.fusion(warped_fwd, warped_bwd, self.fusion_k, t32,
                           perms=perms, generator=generator, momentum=momentum)

    def forward(self, forward_pcds, key_pcds, backward_pcds, t, ini_feature,
                perms=None, generator: torch.Generator | None = None,
                momentum: float = 0.1):
        """``forward_pcds``: ``field`` frames ``[B, N, 3]`` before the key
        pair (nearest first), ``key_pcds``: 2 frames, ``backward_pcds``:
        ``field`` frames after it, ``t [B]`` in (0, 1), ``ini_feature
        [B, N, 3]`` zeros -> interpolated cloud ``[B, N, 3]``.  ``perms`` /
        ``generator``: the fusion's permutations (see ``PointsFusion``);
        ``generator`` and ``momentum`` as in :meth:`from_flows`."""
        with torch.no_grad():
            flows = self.window_flows(forward_pcds, key_pcds, backward_pcds, ini_feature)
        return self.from_flows(*flows, key_pcds, t, perms=perms, generator=generator,
                               momentum=momentum)



class PointINet2(nn.Module):
    """Key-pair PointINet, a ``PointsFusion`` of each ring's warped pair,
    and the ``Wnet``-weighted ``PointsFusionMulti`` over the key fusion and
    the rings (``pci_tpu/models/isapci.py:PointINet2``,
    Models/Models.py:130-188), eval with the flows frozen.  Submodules carry
    flax's names (``wnet``, ``pointinet`` with its own ``flow`` and
    ``fusion``, ``flow``, ``fusion_ring{i}``, ``fusion2``), so
    ``convert.flax_to_state_dict`` loads a JAX checkpoint unchanged.  The
    key PointINet fuses at k = 32, the rings and ``fusion2`` at
    ``fusion_k`` (the reference's 64).

    ``field`` >= 1: the JAX module cannot be built at field 0 (its
    ``Wnet`` ends in a Dense of 6 field = 0 features, whose initializer
    divides by zero), so neither can this one."""

    def __init__(self, field: int, fusion_k: int = 64):
        super().__init__()
        if field < 1:
            raise ValueError(f"PointINet2: field >= 1 (the JAX PointINet2 cannot be built at "
                             f"field {field})")
        self.field, self.fusion_k = field, fusion_k
        self.wnet = Wnet(field)
        self.pointinet = PointINet()
        self.flow = FlowNet3D()
        for i in range(1, field + 1):
            self.add_module(f"fusion_ring{i}", PointsFusion())
        self.fusion2 = PointsFusionMulti()

    def forward(self, forward_pcds, key_pcds, backward_pcds, t, ini_feature, perms=None,
                generator: torch.Generator | None = None):
        """``make_interp_eval_step``'s call: ``forward_pcds`` the ``field``
        frames before the key pair (nearest first), ``key_pcds`` its 2
        frames, ``backward_pcds`` the ``field`` after it, each ``[B, N,
        3]``; ``t [B]``; ``ini_feature [B, N, 3]`` zeros -> ``[B, N, 3]``.
        ``perms``: the 2 + 2 field + (field + 1) fusion permutations ``[B,
        N]`` in the JAX module's draw order (the key PointINet's two, each
        ring's two, then ``fusion2``'s one a cloud); otherwise drawn from
        ``generator``.  The ring flows come from one ``FlowNet3D.multi``
        over the 2 field + 2 frames (each encoded once) on the JAX pair
        plan, divided by the ring's index."""
        field = self.field
        t32 = t.float()
        draws = iter(perms) if perms is not None else None

        def take(n):
            return None if draws is None else [next(draws) for _ in range(n)]

        weights = self.wnet(t32[:, None])  # [B, 6 field]
        fused = [self.pointinet(key_pcds[0], key_pcds[1], ini_feature, ini_feature, t32,
                                perms=take(2), generator=generator)]
        clouds = list(forward_pcds) + list(backward_pcds) + [key_pcds[0], key_pcds[1]]
        k0, k1 = 2 * field, 2 * field + 1
        pairs = []
        for i in range(1, field + 1):
            pairs += [(field - i, k0), (field + i - 1, k1)]
        with torch.no_grad():  # the frozen flow (the JAX module's stop_gradient)
            flows = self.flow.multi(clouds, [ini_feature] * len(clouds), pairs)
        tb = t32[:, None, None]
        for i in range(1, field + 1):
            warped1 = key_pcds[0] + flows[2 * (i - 1)] / i * tb
            warped2 = key_pcds[1] + flows[2 * (i - 1) + 1] / i * (1.0 - tb)
            fused.append(getattr(self, f"fusion_ring{i}")(
                warped1, warped2, self.fusion_k, t32, perms=take(2), generator=generator))
        return self.fusion2(fused, self.fusion_k, weights, perms=take(field + 1),
                            generator=generator)
