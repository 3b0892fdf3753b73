"""9-channel checkpoint surgery (port of ``scripts/modify_checkpoints.py``).

Widens a plain Stable-Diffusion v1 torch checkpoint's first UNet conv from 4
to 9 input channels by concatenating zeros, and writes a new torch .ckpt
that the reference and both packages load. A checkpoint whose conv already
has 9 input channels is copied as it is.

    python -m pbe_tpu_torch.scripts.modify_checkpoints sd-v1-4.ckpt sd-v1-4-modified-9channel.ckpt

(``pipelines/loading.load_checkpoint`` applies the same surgery in memory
when handed a 4-channel checkpoint; this script writes it out as a file.)
"""
from __future__ import annotations

import sys

KEY = "model.diffusion_model.input_blocks.0.0.weight"


def main(argv=None) -> None:
    src, dst = (sys.argv[1:] if argv is None else argv)[:2]
    import torch

    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    w = sd[KEY]
    if w.shape[1] >= 9:
        print(f"{KEY} already has {w.shape[1]} input channels; copying as-is")
    else:
        zeros = torch.zeros(w.shape[0], 9 - w.shape[1], *w.shape[2:], dtype=w.dtype)
        sd[KEY] = torch.cat((w, zeros), dim=1)
        print(f"widened {KEY}: {tuple(w.shape)} -> {tuple(sd[KEY].shape)}")
    torch.save(ckpt if "state_dict" in ckpt else sd, dst)
    print(f"wrote {dst}")


if __name__ == "__main__":
    main()
