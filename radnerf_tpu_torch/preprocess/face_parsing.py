"""BiSeNet face parsing on the card (preprocessing task 4; counterpart of
``radnerf_tpu/preprocess/face_parsing.py``; reference
data_utils/face_parsing/{model,resnet,test}.py).

A 19-class BiSeNet with a ResNet-18 backbone whose spatial path is the
backbone's 1/8 feature (model.py:230-246), producing head/neck/torso/bg
colour masks:

  classes 1-13, 17-18 -> head  (255, 0, 0)
  classes 14-15       -> neck  (0, 255, 0)
  class  16           -> torso (0, 0, 255)
  class  0            -> bg    (255, 255, 255)       (test.py:20-51)

The module's parameter and buffer names are the reference checkpoint's
(``cp.resnet.conv1.weight``, ``cp.arm16.conv.conv.weight``,
``ffm.convblk.bn.running_var``, ..., and the auxiliary heads
``conv_out16`` / ``conv_out32``, which inference does not run), so the
reference's ``79999_iter.pth`` loads with ``load_state_dict(strict=True)``.
The upsampling is JAX's: nearest at the context path's 2x steps, and the
logits bilinear with half-pixel centres (``align_corners=False``; the
reference's model.py upsamples them with ``align_corners=True``). Batch norm
runs in eval mode, so frames may go through in batches.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device

N_CLASSES = 19
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)
BATCH = 16  # frames a forward pass of task 4


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, padding=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(h + sc)


class Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.layer4 = nn.Sequential(BasicBlock(256, 512, 2), BasicBlock(512, 512))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feat8 = self.layer2(self.layer1(x))
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class AttentionRefinement(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout, 3, 1, 1)
        self.conv_atten = nn.Conv2d(cout, cout, 1, bias=False)
        self.bn_atten = nn.BatchNorm2d(cout)

    def forward(self, x):
        feat = self.conv(x)
        atten = feat.mean(dim=(2, 3), keepdim=True)
        return feat * torch.sigmoid(self.bn_atten(self.conv_atten(atten)))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = AttentionRefinement(256, 128)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128, 3, 1, 1)
        self.conv_head16 = ConvBNReLU(128, 128, 3, 1, 1)
        self.conv_avg = ConvBNReLU(512, 128, 1, 1, 0)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        avg_up = F.interpolate(avg, feat32.shape[2:], mode="nearest")
        f32 = self.arm32(feat32) + avg_up
        f32_up = self.conv_head32(F.interpolate(f32, feat16.shape[2:], mode="nearest"))
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(F.interpolate(f16, feat8.shape[2:], mode="nearest"))
        return feat8, f16_up


class FeatureFusion(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, 1, 1, 0)
        self.conv1 = nn.Conv2d(cout, cout // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(cout // 4, cout, 1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = F.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(self.conv2(atten)) + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin, cmid, n_classes):
        super().__init__()
        self.conv = ConvBNReLU(cin, cmid, 3, 1, 1)
        self.conv_out = nn.Conv2d(cmid, n_classes, 1, bias=False)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """x [N, 3, H, W] normalised -> logits [N, n_classes, H, W]
    (model.py:241-258; the auxiliary heads are kept for the checkpoint's
    keys and not run)."""

    def __init__(self, n_classes: int = N_CLASSES):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusion(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def forward(self, x):
        feat8, f16_up = self.cp(x)
        logits = self.conv_out(self.ffm(feat8, f16_up))
        return F.interpolate(logits, x.shape[2:], mode="bilinear", align_corners=False)


def load_torch_weights(path: str, device="cuda") -> BiSeNet:
    """The reference's face-parsing checkpoint (79999_iter.pth) as an eval-mode
    ``BiSeNet`` on ``device``. Batch-norm step counters that an older
    checkpoint lacks are filled with 0; every other key must match."""
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    net = BiSeNet()
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = torch.zeros_like(v)
    net.load_state_dict(sd, strict=True)
    return net.to(dev).eval()


def classes_to_colors(parsing: np.ndarray) -> np.ndarray:
    """Class map [H, W] -> head/neck/torso/bg colour mask (test.py:20-51)."""
    out = np.full((*parsing.shape, 3), 255, np.uint8)  # bg white
    head = ((parsing >= 1) & (parsing <= 13)) | (parsing >= 17)
    out[head] = (255, 0, 0)
    out[(parsing == 14) | (parsing == 15)] = (0, 255, 0)
    out[parsing == 16] = (0, 0, 255)
    return out


def normalize_frame(img_rgb: np.ndarray) -> np.ndarray:
    """An RGB uint8 frame -> the network's [3, 512, 512] float32 input, on the
    host as JAX forms it (cv2 INTER_LINEAR resize, /255, mean/std)."""
    import cv2

    x = cv2.resize(img_rgb, (512, 512), interpolation=cv2.INTER_LINEAR)
    x = (x.astype(np.float32) / 255.0 - _MEAN) / _STD
    return x.transpose(2, 0, 1)


def make_parsing_fn(weights_path: str, device="cuda"):
    """A PreprocessPipeline ``parsing_fn`` on the reference's checkpoint: every
    ``*.jpg`` of ``ori_imgs_dir`` decoded and resized on the host, the
    network and the per-pixel argmax on ``device`` in batches of ``BATCH``
    frames, the class maps back as uint8, coloured and resized
    to the frame's size (INTER_NEAREST), written as ``parsing_dir/<name>.png``."""
    dev = resolve_device(device)
    net = load_torch_weights(weights_path, dev)

    def parsing_fn(ori_imgs_dir: str, parsing_dir: str):
        import cv2

        paths = sorted(glob.glob(os.path.join(ori_imgs_dir, "*.jpg")))
        for lo in range(0, len(paths), BATCH):
            imgs = [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in paths[lo:lo + BATCH]]
            x = torch.from_numpy(np.stack([normalize_frame(im) for im in imgs])).to(dev)
            with torch.no_grad():
                classes = net(x).argmax(dim=1).to(torch.uint8).cpu().numpy()
            for p, img, parsing in zip(paths[lo:lo + BATCH], imgs, classes):
                h, w = img.shape[:2]
                colors = cv2.resize(classes_to_colors(parsing), (w, h),
                                    interpolation=cv2.INTER_NEAREST)
                out = os.path.join(parsing_dir, os.path.basename(p).replace(".jpg", ".png"))
                cv2.imwrite(out, colors)

    return parsing_fn
