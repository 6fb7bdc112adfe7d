"""chip_smoke.py's phase 3 forward kernel checks, from the tree given as
the first argument: odconv_s2 at the flagship's four sites, dcnv2_im2col
at yolo-somi-dcn's rows 6 and 8 and dcnv3_core at row 10 (b8 bf16, cold
L2), each against its plain version, and the kernels' summed ms.

To compare two commits on one card, unpack one of them into a directory
that .gitignore lists and alternate the trees, one process each:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 probe_forward_kernels.py $t; done
"""
import os
import sys

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.SOURCES = ("odconv_s2.cu", "dcn.cu")
    cs.build_all()
    _, meta = cs.parse_model(cs.load_model_cfg(cs.find_config("yolo-somi")))
    gen = torch.Generator(device="cuda").manual_seed(0)
    od = cs.check_kernel(cs.odconv_sites(meta, cs.BATCH, cs.IMGSZ), gen)
    v2_sites, v3_sites = cs.dcn_sites("yolo-somi-dcn", cs.BATCH, cs.IMGSZ)
    v2 = cs.check_dcnv2(v2_sites, gen)
    v3 = cs.check_dcnv3(v3_sites, gen)
    print(f"forward kernels of {root} on {cs.gpu_line()}: odconv_s2 {od['ms']:.4f} dcnv2_im2col {v2['ms']:.4f} "
          f"dcnv3_core {v3['ms']:.4f} ms")
