"""Saliency visualization: Grad-CAM(++), attention rollout, grad x input.

Counterpart of mofo_tpu/cli/attention_vis.py, plus --device (default
cuda), for GradCAM_videoMAE_MOFO.py's capability (pytorch-grad-cam on the
token grid with a box overlay):
  - Grad-CAM / Grad-CAM++: class-discriminative maps at the reference's
    target layer, blocks[layer].norm1 (GradCAM_videoMAE_MOFO.py:293-301):
    a forward hook on that LayerNorm keeps its f32 output A and adds a zero
    perturbation that requires a gradient; the gradient of the class score
    with respect to it is dS/dA (mofo_tpu does this with a flax method
    interceptor);
  - attention rollout (Abnar & Zuidema '20) over the Blocks' sown
    attention probabilities (sow_attn=True, attn_impl="xla": the plain
    math, no kernel);
  - gradient saliency: |d logit[class] / d input|, token-pooled.
The grad and Grad-CAM passes run the model as the finetune path does: at
the published widths its Blocks take K1 and the backward K2. Each map is
rendered as per-frame heatmap overlays (plus the motion box from
--bb_json) into saliency_{i:02d}.jpg.

--model_path is a torch .pth (a finetune checkpoint, or a pretrain one):
whatever matches the classifier is loaded, as mofo_tpu's
import_torch_finetune + finetune_init_from_pretrain load it; an orbax
directory is the JAX package's format, which the port does not read.
Without it the weights come from seed 0.

Usage:
  python -m mofo_tpu_torch.cli.attention_vis --video v.mp4 \\
      --save_path out/ [--model_path ckpt.pth] [--method gradcam++ \\
      --layer 5] [--bb_json boxes.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mofo_tpu_torch.cli.feature_extract import as_encoder
from mofo_tpu_torch.cli.vis import load_clip
from mofo_tpu_torch.core.device import resolve_device
from mofo_tpu_torch.data.filelist import MotionBoxIndex
from mofo_tpu_torch.data.video_reader import VideoReader
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import image as I
from mofo_tpu_torch.train import checkpoint as ckpt


def get_args(argv=None):
    p = argparse.ArgumentParser("MOFO saliency visualization (PyTorch)")
    p.add_argument("--video", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--model_path", default=None)
    p.add_argument("--model", default="vit_base_patch16_224")
    p.add_argument("--nb_classes", default=174, type=int)
    p.add_argument("--input_size", default=224, type=int)
    p.add_argument("--num_frames", default=16, type=int)
    p.add_argument("--method", default="grad",
                   choices=["grad", "rollout", "gradcam", "gradcam++"])
    p.add_argument("--layer", default=5, type=int,
                   help="target block for gradcam methods")
    p.add_argument("--target_class", default=-1, type=int,
                   help="-1 = argmax")
    p.add_argument("--bb_json", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the kernels' plain PyTorch versions")
    return p.parse_args(argv)


def _class_score(logits: torch.Tensor, target_class: int) -> torch.Tensor:
    """The sum over the batch of each clip's target logit (its argmax for
    target_class < 0)."""
    if target_class < 0:
        cls = logits.argmax(dim=-1)
    else:
        cls = torch.full((logits.shape[0],), target_class,
                         device=logits.device)
    return logits.gather(1, cls[:, None]).sum()


def token_saliency_rollout(model_kwargs, state_dict, clips,
                           create_model_fn) -> torch.Tensor:
    """Attention rollout (Abnar & Zuidema '20): per Block, in index order,
    average the sown softmax over heads, add the identity, row-normalize
    and multiply through; token importance = mean over query rows of the
    final rollout. The model is create_model_fn(**model_kwargs, sow_attn=
    True, attn_impl="xla") with `state_dict` loaded. Returns (B, t, h, h)."""
    model = create_model_fn(
        **{**model_kwargs, "sow_attn": True, "attn_impl": "xla"})
    model.load_state_dict(state_dict)
    model.eval()
    with torch.no_grad():
        model(clips)
        mats = [blk.attn.attn_probs for blk in model.blocks]
        B, N = clips.shape[0], mats[0].shape[-1]
        eye = torch.eye(N, device=clips.device)
        rollout = eye[None].repeat(B, 1, 1)
        for a in mats:  # (B, H, N, N)
            a = a.mean(dim=1) + eye[None]
            a = a / a.sum(dim=-1, keepdim=True)
            rollout = torch.matmul(a, rollout)
        sal = rollout.mean(dim=1)  # (B, N)
    t, h = clips.shape[1] // 2, clips.shape[2] // 16
    return sal.reshape(B, t, h, h)


def token_saliency_grad(model, clips: torch.Tensor,
                        target_class: int) -> torch.Tensor:
    """|d logit / d input| pooled per token -> (B, t, h, h)."""
    x = clips.detach().requires_grad_(True)
    g, = torch.autograd.grad(_class_score(model(x), target_class), x)
    B, T, H, W, C = g.shape
    t, p = T // 2, 16
    h = H // p
    sal = g.abs().sum(-1)  # (B, T, H, W)
    return sal.reshape(B, t, 2, h, p, h, p).sum(dim=(2, 4, 6))


def token_saliency_gradcam(model, clips: torch.Tensor, target_class: int,
                           layer: int, plus: bool = False) -> torch.Tensor:
    """Grad-CAM / Grad-CAM++ on the token grid -> (B, t, h, h), at
    blocks[layer].norm1. A forward hook keeps the LayerNorm's f32 output A
    and adds a zero perturbation; the gradient of the class score with
    respect to the perturbation is dS/dA."""
    B, T, S = clips.shape[0], clips.shape[1], clips.shape[2]
    t, h = T // 2, S // 16
    norm1 = model.blocks[layer].norm1
    pert = torch.zeros((B, t * h * h, norm1.normalized_shape[0]),
                       device=clips.device, requires_grad=True)
    captured = []

    def hook(module, inputs, out):
        if captured:
            return None
        captured.append(out.float())
        return out + pert.to(out.dtype)

    handle = norm1.register_forward_hook(hook)
    try:
        score = _class_score(model(clips), target_class)
    finally:
        handle.remove()
    grads, = torch.autograd.grad(score, pert)
    acts = captured[0].detach()  # acts, grads: (B, N, D)
    if plus:
        # Grad-CAM++ (Chattopadhay et al. '18), spatial axis = tokens:
        # alpha = g^2 / (2 g^2 + sum_n A g^3); w_d = sum_n alpha relu(g)
        g2 = grads * grads
        g3 = g2 * grads
        denom = 2.0 * g2 + (acts * g3).sum(dim=1, keepdim=True)
        alpha = torch.where(g2 > 0, g2 / (denom + 1e-8), 0.0)
        w = (alpha * torch.relu(grads)).sum(dim=1)  # (B, D)
    else:
        w = grads.mean(dim=1)  # (B, D)
    cam = torch.relu(torch.einsum("bnd,bd->bn", acts, w))
    return cam.reshape(B, t, h, h)


def main(args=None, reader=VideoReader) -> np.ndarray:
    """Writes the overlays; returns the (t, h, h) map, scaled to a max of
    1. `reader` opens the video (no CLI flag reaches it)."""
    if args is None:
        args = get_args()
    import cv2

    device = resolve_device(args.device)
    os.makedirs(args.save_path, exist_ok=True)
    ids, clips = load_clip(args.video, args.num_frames, args.input_size,
                           device, reader)
    display = clips[0].cpu().numpy()  # (T, S, S, 3) in [0, 1]
    normed = I.normalize(clips)

    model_kwargs = dict(img_size=args.input_size,
                        all_frames=args.num_frames,
                        num_classes=args.nb_classes)
    model = create_model(args.model, device=device, **model_kwargs)
    if args.model_path:
        copied = ckpt.finetune_init_from_pretrain(model, as_encoder(
            ckpt.load_pretrain_encoder(args.model_path)))
        print(f"loaded {len(copied)} tensors from {args.model_path}")
    model.eval()

    if args.method == "rollout":
        sal = token_saliency_rollout(
            model_kwargs, model.state_dict(), normed,
            lambda **kw: create_model(args.model, device=device, **kw))
    elif args.method in ("gradcam", "gradcam++"):
        sal = token_saliency_gradcam(model, normed, args.target_class,
                                     args.layer,
                                     plus=args.method.endswith("++"))
    else:
        sal = token_saliency_grad(model, normed, args.target_class)
    sal = sal[0].detach().cpu().numpy()  # (t, h, h)
    sal = sal / (sal.max() + 1e-9)

    boxes = None
    if args.bb_json:
        idx = MotionBoxIndex.from_file(args.bb_json)
        boxes = idx.get(MotionBoxIndex.video_key(args.video), ids)

    t_pos = sal.shape[0]
    for i in range(args.num_frames):
        frame = (display[i] * 255).astype(np.uint8)[:, :, ::-1].copy()
        heat = cv2.resize(
            (sal[min(i // 2, t_pos - 1)] * 255).astype(np.uint8),
            (args.input_size, args.input_size),
        )
        heat = cv2.applyColorMap(heat, cv2.COLORMAP_JET)
        overlay = cv2.addWeighted(frame, 0.6, heat, 0.4, 0)
        if boxes is not None:
            x1, y1, x2, y2 = (int(v) for v in boxes[i])
            cv2.rectangle(overlay, (x1, y1), (x2, y2), (0, 255, 0), 2)
        cv2.imwrite(
            os.path.join(args.save_path, f"saliency_{i:02d}.jpg"), overlay
        )
    print(f"wrote {args.num_frames} saliency frames to {args.save_path}")
    return sal


if __name__ == "__main__":
    main()
