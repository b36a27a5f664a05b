"""The port covers the JAX package's public surface: for every module of
``vn_celeb_face_recognition_tpu`` (and every repo-root CLI), each public
top-level name has a counterpart of the same name in the port's mirrored
module, or a row in the tables below: a name the port gives another place
or name (checked to exist), or a TPU formulation or JAX-only helper that
ROADMAP.md lists under "Not ported". Both packages are read as source
(``ast``); neither is imported, apart from the torch names a row points
to."""

import ast
import importlib
import os

import pytest
from torch_shared import two_threads  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "vn_celeb_face_recognition_tpu"
PORT_PKG = "vn_celeb_face_recognition_tpu_torch"
ROOT_CLIS = ("train", "eval", "find_embedding", "demo_image", "demo_video",
             "celeb_statistic", "crop_face", "align_face", "split_train_val",
             "false_prediction_vlz")

# JAX module -> the port's module that holds its counterparts, where the
# port names it otherwise (the Pallas kernels' modules hold their CUDA
# kernels' wrappers)
MODULE_MAP = {
    "ops/bottleneck_pallas.py": "ops/bottleneck.py",
    "ops/crop_pallas.py": "ops/crop.py",
    "ops/crops_net_pallas.py": "ops/crops_net.py",
    "ops/emotion_stem_pallas.py": "ops/emotion_stem.py",
    "ops/nms_pallas.py": "ops/nms.py",
    "ops/planar_s1_pallas.py": "ops/planar_s1.py",
    "ops/planar_s1_pallas_v2.py": "ops/planar_s1.py",
    "ops/pyramid_pnet_pallas.py": "ops/pyramid_pnet.py",
    "ops/warp_pallas.py": "ops/warp.py",
    "models/torch_convert.py": "models/convert.py",
    "utils/platform.py": "utils/device.py",
}
# JAX modules with no port module, each listed in ROADMAP's "Not ported"
NOT_PORTED_MODULES = {
    "ops/planar_mnet.py": "XLA layout variant of MobileNet stage 1 (K6 and "
                          "cuDNN compute it)",
    "ops/packed_mnet.py": "XLA layout variant of MobileNet stage 1 (K6 and "
                          "cuDNN compute it)",
    "ops/warp_fast.py": "the TPU's 3-shear warp; K1 computes the exact "
                        "warp",
    "utils/compilation_cache.py": "JAX's persistent compilation cache",
}

# (JAX module, name) -> the port's counterpart, "module:name" in the port
# (or a dotted torch name), and why it differs
RENAMED = {
    ("ops/augment.py", "aug_grayscale"): ("ops.augment:grayscale_apply",
                                          "batched, parameters drawn apart"),
    ("ops/augment.py", "aug_hue_saturation"): (
        "ops.augment:hue_saturation_apply", "batched"),
    ("ops/augment.py", "aug_add"): ("ops.augment:add_apply", "batched"),
    ("ops/augment.py", "aug_multiply"): ("ops.augment:multiply_apply",
                                         "batched"),
    ("ops/augment.py", "aug_gaussian_blur"): (
        "ops.augment:gaussian_blur_apply", "batched"),
    ("ops/augment.py", "aug_contrast"): ("ops.augment:contrast_apply",
                                         "batched"),
    ("ops/augment.py", "aug_sharpen"): ("ops.augment:sharpen_apply",
                                        "batched"),
    ("ops/augment.py", "aug_emboss"): ("ops.augment:emboss_apply", "batched"),
    ("ops/augment.py", "aug_hflip"): ("ops.augment:facenet_aug",
                                      "flip, rotation and crop are one warp"),
    ("ops/augment.py", "aug_rotate"): ("ops.augment:facenet_aug",
                                       "flip, rotation and crop are one warp"),
    ("ops/augment.py", "aug_random_crop"): (
        "ops.augment:facenet_aug", "flip, rotation and crop are one warp"),
    ("ops/augment.py", "batch_apply"): ("ops.augment:rank1_vn_celeb_aug",
                                        "the augmenters take batches"),
    ("ops/bottleneck_pallas.py", "emotion_apply_fused_l12"): (
        "models.resnet_2_branch:ResNet2Branch.forward",
        "the net runs K8 on its tails"),
    ("ops/bottleneck_pallas.py", "fold_bottleneck_block"): (
        "ops.bottleneck:fold_block", "one block's fold"),
    ("ops/bottleneck_pallas.py", "fold_layer_tail"): (
        "ops.bottleneck:fold_block", "K8 folds its blocks one by one"),
    ("ops/crop_pallas.py", "grouped_crop_area_resize_pallas"): (
        "ops.crop:grouped_crop_area_resize", "K4's wrapper"),
    ("ops/crops_net_pallas.py", "fold_crop_net_weights"): (
        "ops.crops_net:pack_trunk_weights", "K5's weight packing"),
    ("ops/crops_net_pallas.py", "rnet_apply_fused"): (
        "models.mtcnn:RNet.forward", "the net runs K5 on its trunk"),
    ("ops/crops_net_pallas.py", "onet_apply_fused"): (
        "models.mtcnn:ONet.forward", "the net runs K5 on its trunk"),
    ("ops/emotion_stem_pallas.py", "emotion_apply_fused"): (
        "models.resnet_2_branch:ResNet2Branch.forward",
        "the net runs K7 on its stem"),
    ("ops/emotion_stem_pallas.py", "emotion_stem_pallas"): (
        "ops.emotion_stem:emotion_stem", "K7's wrapper"),
    ("ops/nms_pallas.py", "nms_keep_mask_pallas"): (
        "ops.nms:nms_keep_mask", "K3's wrapper"),
    ("ops/planar_s1_pallas.py", "fold_stage1_weights"): (
        "ops.planar_s1:pack_stage1_weights", "K6's weight packing"),
    ("ops/planar_s1_pallas.py", "planar_stage1_pallas"): (
        "ops.planar_s1:mnet_stage1", "K6's wrapper"),
    ("ops/planar_s1_pallas_v2.py", "planar_stage1_pallas_v2"): (
        "ops.planar_s1:mnet_stage1", "K6's wrapper (one CUDA design)"),
    ("ops/pyramid_pnet_pallas.py", "fold_pnet_weights"): (
        "ops.pyramid_pnet:pack_weights", "K2's weight packing"),
    ("ops/warp_pallas.py", "batched_similarity_warp_pallas"): (
        "ops.warp:similarity_warp", "K1's windows form"),
    ("ops/image.py", "integral_image"): ("ops.crop:integral_image",
                                         "K4's first half"),
    ("training/checkpoint.py", "restore_variables"): (
        "training.checkpoint:load_state_dict_from_jax", "torch modules"),
    ("training/optim.py", "MultiStepLR"): ("training.optim:make_lr_scheduler",
                                           "torch's schedulers"),
    ("training/optim.py", "ReduceLROnPlateau"): (
        "training.optim:make_lr_scheduler", "torch's schedulers"),
    ("parallel/mesh.py", "mlp_param_sharding"): (
        "parallel.mesh:shard_mlp", "process groups hold the shards"),
    ("models/inception_resnet_v1.py", "Branch"): (
        "torch.nn.Sequential", "a flax stand-in for nn.Sequential"),
    ("models/inception_resnet_v1.py", "Repeat"): (
        "torch.nn.Sequential", "a flax stand-in for nn.Sequential"),
    ("models/inception_resnet_v1.py", "build_inception_resnet_v1"): (
        "models:build_model", "the registry builds it"),
    ("models/inception_resnet_v1.py", "pretrained_weight_candidates"): (
        "models:local_weights", "the local weight file"),
    ("models/iresnet.py", "build_iresnet"): ("models:build_model",
                                             "the registry builds it"),
    ("models/resnet_2_branch.py", "build_resnet_2branch_50"): (
        "models:build_model", "the registry builds it"),
    ("models/resnet_common.py", "ResNetTrunk"): (
        "models.retinaface:ResNet50Body", "the ResNet-50 trunk's taps"),
    ("models/layers.py", "Dtype"): ("torch.dtype", "a flax type alias"),
    ("models/layers.py", "PReLU"): ("models.layers:prelu", "torch's PReLU "
                                    "module, applied in the compute dtype"),
    ("models/layers.py", "adaptive_avg_pool"): (
        "torch.nn.functional.adaptive_avg_pool2d", "torch has it"),
    ("models/layers.py", "conv2d"): ("models.layers:conv", "torch's Conv2d, "
                                     "applied in the compute dtype"),
    ("models/retinaface.py", "MobileNetV1Stage"): (
        "models.retinaface:mobilenet_stage", "an nn.Sequential"),
    ("models/retinaface.py", "MobileNetBodyFromS1"): (
        "models.retinaface:MobileNetV1Body", "K6 runs stage 1 inside it"),
    ("models/retinaface.py", "RetinaFaceNetFromS1"): (
        "models.retinaface:RetinaFaceNet", "K6 runs stage 1 inside it"),
    ("models/mtcnn.py", "load_mtcnn_variables"): (
        "models.mtcnn:load_mtcnn_weights", "torch state_dicts"),
    ("models/torch_convert.py", "convert_state_dict"): (
        "models.convert:state_dict_to_jax", "torch keys to the flax layout"),
    ("models/torch_convert.py", "flax_to_torch_state_dict"): (
        "models.convert:state_dict_from_jax", "the flax layout to torch keys"),
    ("models/torch_convert.py", "load_torch_checkpoint"): (
        "models.layers:read_state_dict", "reads .pt and .npz"),
    ("models/torch_convert.py", "strip_prefix"): (
        "models.layers:read_state_dict", "drops the module. prefix"),
    ("models/torch_convert.py", "flatten_tree"): (
        "models.convert:state_dict_from_jax", "flattens the flax tree"),
    ("models/torch_convert.py", "assert_tree_compatible"): (
        "torch.nn.Module.load_state_dict", "strict loading checks the keys"),
    ("native/loader.py", "NativeVideoReader"): ("native.loader:VideoReader",
                                                "the same runtime reader"),
    ("native/loader.py", "decode_image_file"): (
        "utils.frames:resize_bilinear_half_pixel",
        "read_image, then this resize: bit-exact to it"),
    ("utils/io.py", "save_pandas_df"): ("utils.io:save_csv", "no pandas"),
    ("utils/io.py", "read_image"): ("utils.frames:read_image", "no PIL"),
    ("utils/platform.py", "select_platform"): ("utils.device:select_device",
                                               "torch devices"),
    ("find_embedding.py", "iter_image_batches_native"): (
        "cli.find_embedding:iter_image_batches",
        "use_native chooses the reader"),
    ("demo_video.py", "get_video_fps"): ("cli.demo_video:frame_chunks",
                                         "yields the fps with the frames"),
    ("crop_face.py", "parse_args"): ("cli.crop_face:build_arg_parser",
                                     "the CLIs' parser builders"),
}

# (JAX module, name) -> why the port has no counterpart; ROADMAP.md's "Not
# ported" lists each
NOT_PORTED = {
    ("ops/augment.py", "facenet_aug_batch"): "TPU formulation of facenet_aug",
    ("ops/augment.py", "facenet_aug_shear"): "TPU formulation of facenet_aug",
    ("ops/crops_net_pallas.py", "pack_crops"): "the Pallas kernel's layout",
    ("ops/emotion_stem_pallas.py", "pack_faces"): "the Pallas kernel's "
                                                  "layout",
    ("ops/planar_s1_pallas.py", "supports"): "the Pallas kernel's size limit",
    ("ops/planar_s1_pallas_v2.py", "supports"): "the Pallas kernel's size "
                                                "limit",
    ("ops/pyramid_pnet_pallas.py", "supports"): "the Pallas kernel's size "
                                                "limit",
    ("ops/pyramid_pnet_pallas.py", "phase_pyramid"): "the TPU's phase-split "
                                                     "resize; K2 reads the "
                                                     "integral image",
    ("native/loader.py", "NativeBatchLoader"): "no JAX pipeline uses it; the "
                                               "trainers read through "
                                               "data.loader",
}


def _jax_modules():
    mods = []
    root = os.path.join(REPO_ROOT, JAX_PKG)
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                mods.append(os.path.relpath(os.path.join(dirpath, f), root))
    return sorted(mods)


def _parse(path):
    with open(path) as fp:
        return ast.parse(fp.read())


def public_names(path):
    """A module's public top-level names: ``__all__`` where it has one,
    else its functions, classes and assignments not starting with '_'."""
    tree = _parse(path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    if t.id == "__all__":
                        return set(ast.literal_eval(node.value))
                    names.add(t.id)
    return {n for n in names if not n.startswith("_")}


def bound_names(path):
    """Every name a module binds at top level (imports included), and for
    each class the names its body binds."""
    names, members = set(), {}
    for node in _parse(path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                members[node.name] = {
                    n.name for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names, members


def _port_file(module):
    """'ops.crop' -> the port's source file of that module."""
    base = os.path.join(REPO_ROOT, PORT_PKG, *module.split(".")) \
        if module else os.path.join(REPO_ROOT, PORT_PKG)
    return (os.path.join(base, "__init__.py") if os.path.isdir(base)
            else base + ".py")


def _resolves(target):
    """A RENAMED target exists: "module:Name[.member]" in the port (read as
    source), or a dotted torch name (imported)."""
    if ":" not in target:
        parts = target.split(".")
        for i in range(len(parts), 0, -1):
            try:
                obj = importlib.import_module(".".join(parts[:i]))
            except ImportError:
                continue
            for attr in parts[i:]:
                obj = getattr(obj, attr, None)
            return obj is not None
        return False
    module, name = target.split(":")
    path = _port_file(module)
    if not os.path.exists(path):
        return False
    names, members = bound_names(path)
    head, _, member = name.partition(".")
    return head in names and (not member or member in members.get(head, ()))


def _jax_path(jax_module):
    if jax_module[:-3] in ROOT_CLIS:
        return os.path.join(REPO_ROOT, jax_module)
    return os.path.join(REPO_ROOT, JAX_PKG, jax_module)


def _port_rel(jax_module):
    if jax_module[:-3] in ROOT_CLIS:
        return os.path.join("cli", jax_module)
    return MODULE_MAP.get(jax_module, jax_module)


def _reexports(init_module):
    """A package ``__init__``'s imported names -> the JAX module each comes
    from (a submodule imported whole maps to itself)."""
    pkg = os.path.dirname(init_module)
    out = {}
    for node in _parse(_jax_path(init_module)).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for a in node.names:
                src = node.module or a.name
                out[a.asname or a.name] = (
                    os.path.join(pkg, src.replace(".", "/") + ".py"),
                    None if node.module is None else a.name)
    return out


def uncovered(jax_module, name):
    """Why ``name`` of ``jax_module`` has no counterpart, or None."""
    key = (jax_module, name)
    if key in NOT_PORTED:
        return None
    if key in RENAMED:
        target = RENAMED[key][0]
        return None if _resolves(target) else f"{target} does not exist"
    port_path = os.path.join(REPO_ROOT, PORT_PKG, _port_rel(jax_module))
    if os.path.exists(port_path) and name in bound_names(port_path)[0]:
        return None
    if os.path.basename(jax_module) == "__init__.py":
        # a package re-exports its modules' names: the port's counterpart
        # lives in the port's module
        src, src_name = _reexports(jax_module).get(name, (None, None))
        if src is None:
            return "not bound in the port's package"
        if src_name is None:  # a submodule
            return (None if src in NOT_PORTED_MODULES or os.path.exists(
                os.path.join(REPO_ROOT, PORT_PKG, _port_rel(src)))
                else f"no port module for {src}")
        return uncovered(src, src_name)
    return f"not in {_port_rel(jax_module)}"


CASES = _jax_modules() + [f"{cli}.py" for cli in ROOT_CLIS]


@pytest.mark.parametrize("jax_module", CASES)
def test_every_public_name_has_a_port_counterpart(jax_module):
    if jax_module in NOT_PORTED_MODULES:
        assert not os.path.exists(os.path.join(REPO_ROOT, PORT_PKG,
                                               jax_module))
        return
    port_rel = _port_rel(jax_module)
    assert os.path.exists(os.path.join(REPO_ROOT, PORT_PKG, port_rel)), (
        f"no port module {port_rel}")
    gaps = {name: why for name in sorted(public_names(_jax_path(jax_module)))
            if (why := uncovered(jax_module, name)) is not None}
    assert not gaps, f"{jax_module}: {gaps}"


def test_tables_name_real_jax_names():
    """Every table row names a public name of its JAX module, so a row
    outlives no rename in the JAX package."""
    for jax_module, name in list(RENAMED) + list(NOT_PORTED):
        assert name in public_names(_jax_path(jax_module)), (jax_module,
                                                             name)
    for jax_module in list(MODULE_MAP) + list(NOT_PORTED_MODULES):
        assert jax_module in _jax_modules(), jax_module
