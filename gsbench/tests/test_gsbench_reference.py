"""The reference against itself on a tiny scene: blocks of any size give
the same frame, and the two-stage gradient is one graph's."""
import torch

from gsbench import scene
from gsbench import reference as R


def _tiny(tiny_plan):
    plan = tiny_plan("n3v.train")
    cfg = plan["cfg"]
    sc = scene.make_params(cfg, 11, "cpu")
    p = {k: v.double() for k, v in sc["params"].items()}
    cam = scene.rig_cameras(cfg)[2]
    return plan, cfg, sc, p, (sc["static_mask"], sc["dynamic_mask"]), cam


def test_blocks_give_the_same_frame(tiny_plan, monkeypatch):
    _, cfg, sc, p, masks, cam = _tiny(tiny_plan)
    bg = torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)
    whole, pairs = R.render(p, masks, sc, cfg, cam, 17.0, bg)
    monkeypatch.setattr(R, "BLOCK_ELEMENTS", 4096)
    small, pairs_small = R.render(p, masks, sc, cfg, cam, 17.0, bg)
    assert torch.equal(whole, small) and pairs == pairs_small and pairs[1] > 0


def _one_graph_frame(scr, cfg, cam, bg):
    """The frame as one autograd graph: every tile in one block."""
    W, H = cam["width"], cam["height"]
    tx, ty = cfg["tile"]
    gx, gy = -(-W // tx), -(-H // ty)
    order, start, count = R.tile_lists(scr, cfg, W, H)
    lane = torch.arange(int(count.max()))
    sid = order[(start[:, None] + lane).clamp_max(order.shape[0] - 1)]
    px, py = R._pixels(torch.arange(gx * gy), gx, tx, ty, scr.xy.dtype)
    color, _, _, _ = R._blend(scr.xy[sid], scr.conic[sid], scr.opacity[sid], scr.rgb[sid],
                           lane[None] < count[:, None], px, py, bg)
    return color.view(gy, gx, ty, tx, 3).permute(0, 2, 1, 3, 4).reshape(
        gy * ty, gx * tx, 3)[:H, :W]


def test_two_stage_gradient_is_one_graphs(tiny_plan):
    plan, cfg, sc, p, masks, cam = _tiny(tiny_plan)
    bg = torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)
    gt = torch.rand((cfg["height"], cfg["width"], 3), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    x = R.StepInput(cam, 17.0, gt, bg, 10_000)
    out = R.train_step(p, R.init_state(p), R.init_stats(masks, torch.float64, "cpu"),
                       masks, sc, cfg, x, 1.0)
    loss, g = out.loss, out.grads
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    scr = R.project(*R.splats_at(leaves, masks, sc, cfg, x.t), cam, cfg)
    with torch.enable_grad():
        img = _one_graph_frame(scr, cfg, cam, bg)
        total = R.image_loss(img, gt, cfg["lambda_dssim"]) + R.regularizers(
            leaves, masks, cfg, x.iteration, sc["keyframe_num"])
    grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
    assert abs(float(total.detach()) - loss) < 1e-12
    for (k, v), gk in zip(leaves.items(), grads):
        gk = torch.zeros_like(v) if gk is None else gk
        mask = masks[1] if k.startswith("motion_") else masks[0]
        gk = torch.where(mask.view(-1, *([1] * (v.ndim - 1))), gk, torch.zeros_like(gk))
        assert torch.allclose(torch.nan_to_num(gk), g[k], rtol=1e-9, atol=1e-15), k
