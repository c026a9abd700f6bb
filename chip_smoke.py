#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`yolopoint_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  build      compile the CUDA kernels from `yolopoint_tpu_torch/ops/csrc/`
             (one nvcc process a source, all at once, linked into one
             library loaded with ctypes) and time it;
  kernel     per kernel and input, the kernel against its plain PyTorch
             version on the card (K1 keys bit-equal at batch 16, 1 and 8
             f32, and at the export's (1, 640, 640) and HPatches' (1, 256,
             320) f32, at KITTI's (1, 288, 960) radius 8 f32 and bf16, and at
             the KITTI and COCO exports' (1, 320, 960) and (1, 480, 640) f32,
             with the branch each launch took; K2 keep masks equal, also at
             (1, 1024), KITTI's; K3 within 1e-5 at the serve path's batch 16
             and batch 1, also at KITTI's (1, 36, 120, 128) N = 600, at
             D = 256, SuperPointNet's, on (16, 80, 80), its val batch's
             (8, 80, 80) and HPatches' (1, 32, 40), and at D = 64, 192 and
             320, YOLOPoint-n's, -m's and -x's, f32 and bf16), with
             median times
             from CUDA events, `kernel_ms` (its launches alone under a CUDA
             graph) and the bound's share of it, and the launches the check
             made; K3's `kernel_ms` cycles through copies of its inputs so
             that they come from memory as its bound counts them
             (`k3_memory_ms`), `kernel_l2_ms` replays one input, and
             `library_ms` is `F.grid_sample` + `F.normalize` on the same
             inputs (held to 1e-5 of the plain version first);
  kernel     (K3 instantiations) every instantiation of K3's kernel through
             its wrapper (each family width, the generic one at D = 100 and
             on an unaligned map) in f32 and bf16 within 1e-5 of the plain
             version;
  kernel     (K2 val tiles) K2 on the inputs of every K2 launch of one
             `TrainAgent.validate` batch of the val phase's config (the
             tiles of the box-NMS scan, recorded by wrapping the NMS
             module's `greedy_nms_keep`): each keep mask equal, the tile and
             valid counts, times per tile;
  kernel     (warp) the homography warp kernel (K4 and K5) against its plain
             version: bilinear within 1e-5 at (32, 640, 640, 3), nearest
             bit-equal at (32, 80, 80, 1), and the other `WARP_INPUTS` (the
             export's views (50, 640, 640, 3) and warps back (50, 640, 640,
             1), KITTI's (10, 320, 960, 3 and 1) and COCO's (100, 480, 640,
             3 and 1) at their configs' homographies, the export CLI's (50,
             256, 320, 3 and 1), a zoom-out that
             reaches the global branch,
             a w2 sign change, ragged tiles, W * C odd, C = 2 and 4, one
             (3, 3) homography), NaN at the same pixels; the tiles that took
             the global branch (the kernel's counter) equal to those whose
             window exceeds the budget; `kernel_ms` the launches alone under
             a CUDA graph beside the wrapper's `ms`; with `F.grid_sample` on
             the same inputs, in the same mode, as the library yardstick.
             Fails if more than 5% of the train path's K4 tiles, or none of
             the zoom-out's, take the global branch;
  kernel     (K6) the suppressed keypoint map bit-equal to its plain version
             at (16, 640, 640) bf16 radius 4, at (1, 256, 320) f32, and at
             two inputs no tile divides, with `kernel_ms` as K1; no single
             PyTorch call computes it;
  kernel     (large radii) K6 at (16, 640, 640) f32 r=15 and (1, 64, 64) f32
             r=60, K1 at (16, 660, 660) bf16 r=22 (tile 22): launches no
             block interior fits, through the global-memory branch (counted
             under its own key, `branch`), bit-equal, with `kernel_ms`;
  reference  YOLOPoint-S in f32 on a small input: the forward on the card
             against the CPU, and the decode on the card (kernels) against
             the CPU decode (plain versions) of the same forward outputs:
             boxes at the 0.25 gate, boxes at the 0.001 gate (the nc=5 s640
             model's predictions decoded on the card; at least one box,
             counts and classes equal, coordinates within 1e-4), keypoints
             at radii 3 and 7 (K6; equal);
  serve      YOLOPoint-S (nc=80, 640x640, bf16, BN folded, seeded random
             weights) through `InferencePipeline` at the benchmark operating
             point, on uint8 batches of 1 and 16; checks shapes, finiteness
             and that K1, K2 and K3 each launched on this path;
  serve_untiled
             the same pipeline at NMS radius 3 (640 is no multiple of 3),
             batch 16: keypoints through K6, one launch per request, no K1;
  serve_frame
             `InferencePipeline.process_frame(frame, img_size=640)` on a
             720x1280 uint8 frame (the demo operating point): the resize
             without OpenCV, then one K1, K2 and K3 launch per frame;
  serve_kitti
             the KITTI demo and ROS operating point of
             `configs/kitti_inference.yaml`: YOLOPointv52-S (nc=7, bf16, BN
             folded), `process_frame(frame, img_size=960)` on 12 uint8
             375x1242 frames of a panning scene ((1, 288, 960) requests), its
             settings merged as the JAX ROS node takes them (only the
             keypoint threshold lowered to 0.015), a `PointTracker(4, 0.7)`
             updated every frame and `get_tracks(2)` read: frame p50, tracks
             alive, one K1, K2 and K3 launch a frame; card against CPU on the
             same raw outputs (keypoints, descriptors, boxes at the config's
             gate and at 0.001 on the same decoded predictions, the
             tracker's matches and tracks; the card's heatmap decoded on
             both sides);
  serve_families
             YOLOv8Point-S (nc=80), YOLOPointDet-S and SuperPointNet, bf16,
             at the serve operating point, one batch-1 and one batch-16
             request each: exactly the JAX pipeline's keys (no box keys for
             the two without a Detect head), the launches, and card against
             CPU on the batch-16 raw outputs;
  aot        the serving artifact (`export.aot`, `torch.export` with K1/K2/
             K3 as `torch.library` ops): YOLOPoint-S 640 px bf16 fused at the
             serve point, exported on the card at B = 1 and 16 (seconds,
             bytes), reloaded, ms a request against the eager pipeline in
             turns, outputs held to the eager pipeline's (keypoints and
             boxes equal, descriptors within 1e-4), K1-K3 launched once a
             request by the loaded program; eager serving with the ops
             against the wrappers called directly (the dispatcher's cost);
  demo       `python -m yolopoint_tpu_torch.frontend.demo --track --save-dir
             --timing` on 8 panning 480x640 frames the port's PNG and JPEG
             writers wrote, a seeded YOLOPoint-S file (bf16 fused): ms a
             frame reading, inferring, tracking and drawing, encoding; every
             saved JPEG decodes and is byte-equal to the same drawing's
             encoding by the numpy twin (the drawings captured in a second,
             in-process run whose files equal the command's); the encoder at
             640x480, compiled against numpy;
  demo_kinds `demo.main` in this process over a directory of 240x320 files of
             every kind slices 21 and 22 read (arithmetic-coded and lossless
             JPEG, 1- to 32-bit BMP, P1-P6 at maxvals 1-65535, TIFF, GIF, Sun
             raster, PAM, PFM, Radiance) and of the kinds `cv2.imread`
             returns None for (`image_kind_files`), every numpy twin of a
             sequential decoder refused (`no_numpy_decoders`): the stems
             served and skipped equal `IMAGE_KINDS_SERVED` /
             `IMAGE_KINDS_SKIPPED`, the lists the CPU test takes from the JAX
             demo; one K1, K2 and K3 launch a served frame; each served read
             equal to the numpy read; ms a read;
  demo_video `demo.main` in this process on `tests/data/video/mp4v_480x640.mp4`
             (MPEG-4 Part 2, 12 frames) with the same seeded YOLOPoint-S
             file, every numpy decoder refused: frames named `000000`...
             as the JAX demo names them, every frame served with one K1, K2
             and K3 launch, keypoints on each; the read and infer ms a frame;
  ros        the ROS layer on a fake rospy / sensor_msgs / keypoint_msg /
             object_msgs / message_filters stack (no cv_bridge): the node of
             `ros_param_node.build_node` from the `yolocfg` of the port's
             `ros_pkg/launch/yolopoint.launch` (YOLOPoint-S 640 px bf16 fused,
             nms 8, top_k 600; only the keypoint threshold lowered to 0.015,
             the Detect biases of the seeded weights raised) with a grey PNG
             template on camera `cam0`; 12 panning 720x1280 `sensor_msgs/Image`
             messages (bgr8, one rgb8, one bgra8 with padded rows, one mono8):
             the callback's p50 and its split (decode, process_frame, mask,
             publish), keypoints and instances a frame, one K1, K2 and K3
             launch a frame; the card's messages against the CPU decode of
             the same raw outputs (`decode_both`, `compare_decodes`), no
             published point on the eroded template, the listener's tracks;
             templates from a lossless JPEG, a PBM and a 16-bit grey TIFF
             loaded (masks equal to the CPU node's) and one `cv2.imread`
             returns None for skipped;
             then the host code on the card against its numpy twins
             (covariance packing, grey reads, progressive / multi-scan JPEG,
             Adam7 PNG, run-length BMP) and the JPEG fixtures of
             `tests/data/` against the SHA-256 of `cv2.imread`'s pixels;
  train_reference
             one micro-step of the train step, f32 with TF32 off,
             YOLOPoint-n at 128x128, B=2: on the card (kernels) against the
             CPU (plain versions), same weights, batch and random draws;
             losses within 1e-4 relative, gradient norms within 1e-3;
  train      `TrainAgent` on the training config of
             `configs/synthetic_s640.yaml` (YOLOPoint-S, nc=5, 640x640, B=32,
             bf16, accum 2): 2 warm-up and 6 timed micro-steps (3 optimizer
             updates) on seeded uint8 batches; time per micro-step, a
             CUDA-event split, peak memory and every loss term; checks
             finite losses, parameters moving only on update steps, the EMA
             moving, and 2 K4 + 1 K5 warp launches per micro-step;
  val_reference
             the val step in f32 with TF32 off, YOLOPoint-n nc=5 at 128x128,
             B=2, on the card against the CPU (same weights, batch, draws):
             losses within 1e-4 relative; the decode of the card's heatmap,
             descriptor map and predictions equal on both (keypoints equal,
             descriptors within 1e-5, detections matched within 1e-4, more
             than 0 boxes);
  val        `TrainAgent.validate` on the s640 config with its val
             augmentation (YOLOPoint-S, nc=5, 640x640, B=8, bf16): 1 warm-up
             and 4 timed batches (the 32 images of the extended metrics);
             time per batch, a CUDA-event split, candidates and detections
             per image, peak memory and every scalar; the host part's split
             a batch (mutual matching, the compiled RANSAC, the rest); checks
             finite scalars, more than 2048 candidates per image (the tiled
             box-NMS scan), K1-K5 launched on this path and no numpy RANSAC;
  fit        the training entry: `training.cli.main` on
             `configs/synthetic_s640.yaml` (read and written by the port's
             YAML code) cut to 128 train and 16 val images, 2 epochs, val
             and a checkpoint every epoch (YOLOPoint-S, nc=5, 640x640, B=32,
             bf16, accum 2, EMA; the set rendered on the host without
             OpenCV and put on the card), then `--resume` to 3 epochs, then
             a warm start from a seeded nc=80 reference-schema file with
             shrink-perturb: render seconds per image, seconds per epoch, ms
             per micro-step beside `train`'s, ms per val batch, checkpoint
             writes, peak memory, the resident set's GB, every val scalar
             and file; checks finite losses and scalars, the files and
             `done.json` against the schedule, the resumed state equal to
             the saved one tensor by tensor, only Detect tensors mismatched
             in the warm start, and K1-K5 launched on this path
             (`host_warp: false`: the device warp path);
  fit_host   the same entry with no `host_warp` key, so the CLI's rule
             picks the host warp (4 or more cores; on fewer it is set and
             the line says so): 2 epochs of 4 micro-steps; `os.cpu_count()`,
             the logged path, ms a micro-step, the loader's wait before each,
             the host warp's wall and thread-seconds a batch, ms a val batch
             and peak memory beside `fit`'s; checks finite losses and
             scalars, no K4 launch and one K5 in each micro-step;
  fit_families
             the CLI with `--model YOLOPointv52|YOLOPointDet|YOLOv8Point|
             SuperPointNet --version s` on the same config cut to 2
             micro-steps and one val batch: ms a micro-step and a val batch,
             peak memory; checks finite losses and scalars, the parameters
             moved, K2 launched exactly for the families with a Detect head;
  ransac     OpenCV's RANSAC homography (`cv2.findHomography(..., cv2.RANSAC)`
             without OpenCV, `evaluation/homography_ransac.py`) on the
             card's host: the compiled `yp_find_homography` against the
             numpy version on `tests/test_torch_ransac.py`'s 50 seeded
             problems and an HPatches-sized one (300 matches, 60% outliers):
             `None` in the same places, equal masks, H within 1e-9 relative;
             ms a call of each;
  jax_weights_read
             the JAX package's trained orbax runs in the checkout
             (`artifacts/synth_s640_pseudo2`, the YOLOPoint-S flagship, and
             `artifacts/synth_r5_pseudo_ext`; a missing file raises) read
             by the compiled reader (`ops/csrc/host_zstd.cpp`; a Python
             decode raises): every array against
             `tests/torch_orbax_digests.json` (orbax's restore), bit for bit,
             MB of frames, seconds and MB/s, `load_weights`' seconds; the
             compiled zstd and CRC-32C against the Python ones on the small
             arrays' frames and every manifest and node;
  jax_weights_serve
             the flagship from its orbax directory through
             `deploy_model` + `InferencePipeline` (BN folded, bf16, the
             serve point) on 16 images of its own validation split: ms a
             request, boxes against the rendered labels (recall and
             precision at IoU 0.5, both >= 0.5), one K1, K2 and K3 launch a
             request, each kernel held against its plain version on the
             recorded trained inputs (K2's tiles must hold valid boxes);
  jax_weights_hpatches
             `hpatches_runner.main` from each run's orbax directory over the
             committed 120-pair `datasets/hpatches_synth`, bf16 and `--f32`:
             every metric beside the run's `hpatches.json` and the JAX
             runner's CPU numbers (`JAX_CPU_HPATCHES`), held to 0.01
             (repeatability) and each correctness@k to 2/120 (f32) and
             8/120 (bf16);
  hpatches   `evaluation.hpatches_runner.main` (the CLI's fused bf16 path,
             256x320) on 2 scenes x 5 pairs written at run time in the
             HPatches layout (PPM images warped on the card, `H_1_n`
             files), with seeded YOLOPoint-n weights saved in the reference
             schema and read by the port's loader: the metrics, ms per pair,
             its host split (inference with the copies to the host, mutual
             matching, the RANSAC, the rest), and 2 launches a pair of K1, K2
             and K3; every homography by the compiled RANSAC (a numpy one
             fails the phase);
             Then `--model SuperPointNet` (no weights file: the runner's
             seeded initialization) on 5 of the pairs: 2 launches a pair of
             K1 and K3 (D = 256), none of K2;
  hpatches_reference
             one of those pairs in f32: the decode of the same raw outputs
             on the card and on the CPU, keypoints equal, descriptors within
             1e-5, the mutual matches equal; the pair's metrics with the
             card run's compiled RANSAC against the CPU run's numpy one:
             inlier masks equal, H within 1e-9 relative, every metric equal
             (the corner error within 1e-9 relative);
  export     `export.export_pseudo_labels` at the settings of
             `configs/synthetic_s640_export.yaml` (YOLOPoint-S, nc=5, N = 50
             views, 640x640, f32, BN unfolded): 1 warm-up and 4 seeded grey
             images; seconds per image, a CUDA-event split, peak memory, 3
             K4 and 1 K1 launches an image, the warp's global-branch tiles
             per warp, and every file's points;
  export_reference
             the aggregate heatmap of one 128x128 image, N = 4 views, on the
             card against the CPU within 1e-5, and the keypoints of the
             card's aggregate equal on both;
  export_kitti, export_coco
             `export` at `configs/kitti_export.yaml` (SuperPointNet, N = 10,
             3 grey 320x960 images: a KITTI frame after the dataset's export
             resize) and `configs/coco_export.yaml` (YOLOPointDet-S, N = 100,
             top_k 1000, 3 grey 480x640 images), f32: the split, peak memory,
             the launches and the warp's global tiles; for KITTI also the
             aggregate of one image card against CPU within 1e-5 and the
             keypoints of the card's aggregate equal on both;
  export_cli `python -m yolopoint_tpu_torch.export.cli` on
             `configs/synthetic_export.yaml` cut to 8 of its 1024 images,
             with a seeded weights file: one `.npz` an image with the JAX
             CLI's key, 3 warp launches (K5 at 256x320) and 1 K1 launch an
             image.
  export_host
             `export_pseudo_labels(host_warp=True)` at the s640 export
             settings (N = 50, 640x640, f32), 1 warm-up and 3 images: the
             warps in compiled host code, the forwards and K1 on the card;
             s an image and its host split; checks no warp launch and one
             K1 an image; the first image's homographies equal to a CPU
             run's from the same seed, its 4-view aggregate card against
             CPU within 1e-5.
  cv_warp    OpenCV 5's 8-bit `warpPerspective` and `warpAffine` as the
             synthetic-data tools run them (`data/cv_warp.py`), compiled host
             code against numpy byte for byte on a seeded sweep, and
             `tools.synthetic_sequence` on the card against the CPU;
  bootstrap  `tools.bootstrap` (the JAX `tools/bootstrap.py`'s twin) on the
             synth_r5 configs cut in depth (64 + 16 images, 2 epochs; 16
             exported images at 50 homographies; 1 epoch of retraining), each
             stage's CLI in this process, HPatches on 2 scenes that
             `tools.synthetic_hpatches` renders on the card (its first scene
             held to the JAX tool's SHA-256): each stage's seconds and
             launches, the runs' files, the export's count, finite fitness,
             the HPatches keys (their homographies by the compiled
             RANSAC: a numpy one fails the phase); then K1, K3 and the warp
             on the inputs
             recorded in the chain and K1, K2 and K3 on a val batch of the
             retrained run, each against its plain version.
             `python3 chip_smoke.py --bootstrap-chain OUT [STAGE1_SECONDS]`
             runs the whole chain at synth_r5's configs instead
             (`bootstrap_chain`);
  png        the compiled host code of the datasets (`ops/csrc/host_image.cpp`)
             against its numpy twins, bit for bit: the PNG unfilter on
             images of every colour type and bit depth with each filter
             type, the resize (area, bilinear) of a KITTI frame; the decode
             time of one 375x1242 RGB PNG and the resize times;
  jpeg       the compiled JPEG decoder (`yp_jpeg_decode`) against its numpy
             twin, bit for bit, on files of `encode_jpeg` (a numpy baseline
             encoder: Annex K tables, float DCT) at 4:2:0, 4:2:2, 4:4:0,
             4:4:4, 4:1:1 and grey at odd sizes, with each EXIF orientation
             and with restart intervals, and one 480x640 4:2:0 q95 frame;
             each within `JPEG_PSNR_DB` of what was encoded; the
             arithmetic-coded and lossless files of `jpeg_kind_cases` (both
             reads; the lossless ones equal to their samples); the frame's
             decode time, compiled and numpy, and the same frame as SOF9, its
             green channel and the frame lossless;
  video      the video fixtures of `tests/data/video/` (`mp4v` MP4, MJPEG AVI
             at 480x640, a 4:2:2 MJPEG AVI) read on the card's path (compiled
             `yp_mpeg4_decode_vop`, `yp_jpeg_coefficients`, `yp_mjpeg_idct`,
             `yp_yuv_to_bgr`): every frame's SHA-256 equal to cv2's
             (`video_fixtures.json`) and the frames equal to the numpy
             decode; each codec's p50 ms a frame, compiled and numpy;
  image_formats
             the readers of TIFF, GIF, Sun raster, PAM, PFM and Radiance
             (`image_format_files`: this script's numpy writers, every TIFF
             compression, layout and photometric the port reads, GIF tables,
             interlacing, transparency and clear codes, each Sun raster
             depth, PAM tuple types, PFM byte orders, Radiance run-length and
             flat) on the card's path (compiled `yp_tiff_lzw`, `yp_packbits`,
             `yp_jpeg_decode`, `yp_gif_lzw`, `yp_hdr_rgbe`) bit-equal to their
             numpy twins in colour and in grey; a 480x640 frame of each
             kind's decode, compiled (p50 of 7) against numpy, beside the
             Huffman JPEG frame's;
  host_warp_reference
             the host warp in compiled host code against its numpy twin,
             bit for bit: bilinear and nearest at C = 1 and 3, the warp
             coverage and the erosion, at (640, 640, 3) with s640
             homographies, a (320, 960, 3) KITTI frame with crop-conjugated
             ones and the (576, 1792, 3) mosaic canvas; ms a call of both;
  views_host_reference
             `host_warp_views` compiled against numpy on the same batch and
             seed (payloads bit-equal), then `build_training_views(
             precomputed=...)` card against CPU (images within 1e-5, label
             maps and masks equal), in plain (s640, 640x640), crop (KITTI,
             320x960) and mosaic (576x1792) mode;
  views_reference
             `build_training_views` under `configs/kitti.yaml` on two
             batches of the written KITTI tree (below) in crop mode ((2,
             320, 960) frames) and mosaic mode ((2, 576, 1792) canvases),
             card against CPU on the same batch and draws: images within
             1e-5, label maps and masks equal;
  fit_kitti  `training.cli` on `configs/kitti.yaml` as published, on the
             device warp path (`host_warp: false`) (YOLOPoint-S,
             8 names with DontCare, bf16, B=16, accum 4, 960 px, 288x896
             device crop, mosaic 0.5, EMA, `freeze_layers`, shrink-perturb)
             over a KITTI tree written at run time (32 train and 8 val RGB
             PNG files of 375x1242, YOLO labels with DontCare rows, 300-600
             points each), 2 epochs, `pretrained` a seeded nc=80 file, a
             seed with both batch kinds, the config's `val_plots: true`:
             PNG decode and dataset time, ms a micro-step plain and mosaic,
             ms a val batch, the plots' host seconds a validation, peak
             memory; checks finite losses and scalars, the frozen tensors
             unchanged, no DontCare box in a batch, each validation's panels
             and confusion matrix written, K1-K4 launched (the cell mask's
             36 rows send it to K4, as the JAX gate does);
  detect_kitti
             `evaluation.detect_cli.main` on the tree's val split with the
             run's `best.pt`: finite metrics over 8 images, K2 launched;
  export_kitti_cli
             `export.cli` on `configs/kitti_export.yaml` over the 32 train
             PNG files: one `.npz` an image with the JAX CLI's key, 3 K4
             and 1 K1 launches an image;
  export_coco_cli
             `export.cli` on `configs/coco_export.yaml` as published
             (YOLOPointDet-S, f32, N = 100) over 8 of a COCO tree's JPEG
             files written at run time (below), a seeded `--weights` file:
             s and JPEG decode ms an image, one finite `(K, 3)` `.npz` an
             image, 3 K4 and 1 K1 launches an image;
  fit_coco   `training.cli` on `configs/coco.yaml` as published (YOLOPoint-S,
             nc = 80, 640 px letterbox, B = 32, accum 2, bf16, EMA) over
             the COCO tree (64 train and 16 val 480x640 JPEG files at q95,
             4:2:0 / 4:2:2 / 4:4:4, some with a DRI or an EXIF orientation,
             YOLO labels of 80 classes, 300-600 points each), one epoch,
             `val_plots` off (timed in fit_kitti), a seeded nc = 80
             `pretrained` file with the
             Detect biases raised (boxes pass conf 0.001), the CLI's warp
             path (the host on 4 or more cores): ms a micro-step, the loader's wait, JPEG decode
             thread-seconds a batch, ms a val batch, peak memory, the
             logged path; checks finite losses and scalars, a checkpoint,
             K1-K3 launched and one K5 (no K4) a micro-step on the host path;
  detect_coco
             `evaluation.detect_cli.main` on the COCO val split with
             `fit_coco`'s `best.pt` (nc = 80): finite metrics over 16 JPEG
             files, ms an image, K2 launched;
  fit_concat `training.cli.build_agent` on `configs/concat_datasets.yaml`
             (KITTI's PNG tree and COCO's JPEG tree, length-normalized
             draws; mixed batches collated on a shared canvas), then 4
             micro-steps: both datasets drawn, finite losses, one cell-mask
             warp a micro-step on the host path; ms a micro-step, the wait;
  kernel     (KITTI and COCO shapes) K1 at the val's (8, 288, 896) f32, K3
             at (8, 36, 112, 128) N = 600, the warp at the fine-tune's crop
             and mosaic views, canvas mask, pair mask and cell mask, K2 on
             the tiles of the fits' first validations and of
             `detect_kitti` / `detect_coco` (some tiles holding boxes), the
             warp on the device-warp inputs that `fit_coco` and `fit_concat`
             gave it (the cell mask at each canvas's shape, recorded by
             wrapping `warp_image_cuda`). Every COCO phase runs with the
             numpy twins refused (`no_numpy_decoders`): the card's paths
             decode in compiled host code.
  dp_step    (after fit_host) data parallelism, in worker processes of this
             script (`--worker`, one a rank, each with a deadline): one rank
             over NCCL, deterministic algorithms, the s640 config at full
             width: the DP step from a saved state equal in every tensor to
             the step without a mesh (no collective is called at world
             size 1); two ranks over gloo sharing the card (NCCL cannot put
             two ranks on one GPU), global B = 32: 3 timed micro-steps, ms a
             micro-step a rank, the all-reduce's CUDA-event and host time
             after a barrier, the barrier's wait (for the slowest rank),
             the all-reduce's share and the share of both, peak memory a
             rank, K4/K5 launches a rank, the ranks' states bit-equal; and
             the 2-rank YOLOPoint-n 128 px f32 step on the card against the
             same on the CPU (losses 1e-4 relative, gradient norms 1e-3:
             `train_reference`'s; BatchNorm statistics 1e-5 + 1e-5
             relative);
  multi_step K = 4 on the s640 config, one rank: a `make_multi_step`
             dispatch and a `make_device_multi_step` dispatch on (4, B) rows
             of a resident set each equal in every tensor to 4 single
             micro-steps from the same state, the scalars stacked (4,); on
             the two gloo ranks a dispatch whose third micro-step holds a
             NaN pixel in rank 1's rows: `nonfinite_skip` [0, 0, 1, 0] on
             both, their states still equal;
  sharded_serve
             `InferencePipeline.sharded()` at world size 1 (NCCL) and 2
             (gloo) against the one-card pipeline on each rank's rows
             (`dp_serve`): YOLOPoint-S f32 at B = 16, its Detect biases
             raised so that boxes pass, every output equal but the
             descriptors (within 1e-5), some boxes valid;
  spatial    `spatial_sharded_forward` on the two gloo ranks, YOLOPoint-S
             f32 at 640x640 (320 rows a shard, `dp_spatial`): the gathered
             maps within 1e-4 of the whole-image forward, both times, the
             halo all-gathers;
  fit_dp     `torchrun -m yolopoint_tpu_torch.training.cli` on `fit`'s config
             with `steps_per_dispatch: 4` and a profiler window over
             micro-steps 4-7: 1 rank over NCCL (rank 0's files, the trace
             holding exactly the window's 4 micro-steps, its kernels),
             `--resume` to a third epoch, then 2 ranks over gloo for one
             epoch on the CLI's default (host-warp) path (each rank's
             micro-steps, train seconds, loader wait, threads and peak
             bytes on other cards); s an epoch and ms a micro-step beside
             `fit`'s;
  dryrun     `python -m yolopoint_tpu_torch.parallel.dryrun` at 2 ranks (gloo,
             one card) and 1 (NCCL): the JAX gate's summary fields.
             The launches of a multi-rank phase are summed over its ranks;
Then a `{"kernels": [...]}` summary line (K2 with its val-tile times, K1 and
K6 with their global branch's key, launches on every path, the lines at the
shapes of the paths other than the kernel's own, and checked lines), the
card's name and power limit as
`nvidia-smi` reports them, and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Any failure raises, so the exit code is non-zero; without a GPU, or outside a
checkout of the repository, it exits non-zero before printing any result.

    python3 chip_smoke.py --cards 4 [--phases dryrun4,dp_step4,...]

runs the multi-card paths instead, one NCCL rank a card of one host
(`cuda:<rank>`), with fewer than 4 visible cards raising, the count named
(never gloo, fewer ranks or the CPU). The kernels are built once before any
rank starts. Phases (all, or those `--phases` names):
  cards      every card's index, name and power limit, the device count,
             NCCL's version, `nvidia-smi topo -m`;
  dryrun4    `python -m yolopoint_tpu_torch.parallel.dryrun --nproc 4` (NCCL):
             the summary with a finite loss;
  dp_step4   `dp_train` on 4 ranks in one worker session of this script
             (`cards_worker`): `configs/synthetic_s640.yaml` as written,
             global B = 32, 8 rows a rank, accum 1; 1 warm-up and `DP_STEPS`
             timed micro-steps: ms a micro-step a rank, the all-reduce's
             CUDA-event and host ms after a barrier, the barrier's wait,
             the shares, peak memory a rank, the
             ranks' parameters, statistics and optimizer state bit-equal,
             2 K4 and 1 K5 launches a micro-step a rank; NCCL's channel
             transports from its INIT log; then the one-card step on the
             whole 32-row batch in this process (`train`), the yardstick;
  multi_step4
             a dispatch of 4 whose third micro-step holds a NaN pixel in
             rank 3's rows only: skipped on all four ranks, states equal;
  dp_reference4
             `dp_reference` (YOLOPoint-n, 128 px, global B = 4, one row a
             rank) on the cards against four gloo ranks on the CPU: losses
             1e-4 relative, gradient norms 1e-3, BatchNorm statistics 1e-5
             + 1e-5 relative;
  sharded_serve4
             `dp_serve` on a global batch of 64 (16 a rank): every rank's
             outputs of the whole batch, boxes among them, equal to the
             one-card pipeline's on the same rows at 16 a call
             (descriptors within 1e-5); ms a global batch against the
             one-card pipeline's for the 64 images;
  spatial4   `spatial_sharded_forward` of YOLOPoint-S f32 at 640x640, B = 2,
             at (data, spatial) (1, 4) and (2, 2): the maps within 1e-4 of
             the whole-image forward, ms against it, the halo all-gathers a
             forward and their bytes;
  fit_dp4    the training CLI under `torchrun --nproc_per_node 4` (`fit`'s
             config, `FIT_DP_OVERRIDES`): 2 epochs, `--resume` to 3, then 1
             epoch on the CLI's default (host) warp path (`fit_dp`): each
             rank's log line, threads, `epoch_timing`, launches, warp path
             and peak bytes on the other cards (0); rank 0's files, one
             profile trace a rank;
  kernel     each rank's first input of each shape and mode of K4 and K5
             (dp_step4) and of K1, K2 and K3 (sharded_serve4), held against
             its plain version on that rank's card: exact, K3 within 1e-5;
             K2's tiles hold valid boxes. No rank's worker allocates on
             another card.
Then the `kernels` line (K1-K5, launches a rank and summed), every card's
name and power limit, and the same last line, `count` 4.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import weakref
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
SERVE_CONFIG = {  # the benchmark operating point of the JAX package's bench.py
    "detection_threshold": 0.015, "nms": 4, "top_k": 1000, "conf_thresh": 0.25,
    "iou_thresh": 0.45, "max_det": 300, "heatmap_dtype": "bf16", "max_nms": 512,
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of `fn` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- kernels


def heatmap_batch(gen, B, H, W, dtype):
    """Probability-like maps: a background around the 0.015 threshold (bf16
    makes plateaus of equal values there) plus sparse peaks."""
    dev = gen.device
    hm = torch.rand(B, H, W, generator=gen, device=dev) * 0.02
    n = B * H * W // 400
    idx = torch.randint(0, B * H * W, (n,), generator=gen, device=dev)
    hm.view(-1)[idx] = torch.rand(n, generator=gen, device=dev) * 0.9 + 0.1
    return hm.to(dtype)


def nms_bound(hm, out, radius: int, it: int) -> tuple[float, str]:
    """K1's and K6's bound: one read of the heatmap and one write of the
    output, against 2r compares a pixel for each of the 2*it-1 separable
    window maxima (both directions) plus 15 for the rest, over the f32 rate
    (which counts an FMA as two operations; a max or a compare is one
    instruction, so at the f32 instruction rate the same count takes twice
    as long)."""
    B, H, W = hm.shape
    n_bytes = hm.numel() * hm.element_size() + out.numel() * out.element_size()
    n_ops = B * H * W * ((1 + 2 * (it - 1)) * 2 * 2 * radius + 15)
    return bound(n_bytes, n_ops)


def check_k1(gen, B, dtype, reps, H=640, W=640, r=4):
    """K1, the tile keys at the serve path's operating point (radius `r`, its
    tile), against its plain version: bit-equal. `ms` times the wrapper
    between two events, `kernel_ms` its launches alone under a CUDA graph
    (`graph_ms`); `branch` the launch-count key the launch took (the
    shared-memory kernel, or `nms_tile_keys_global`)."""
    return check_k1_on(heatmap_batch(gen, B, H, W, dtype), 0.015, r, 3, 4, reps)


def check_k1_on(hm, conf, r, it, border, reps, tile=None):
    """`check_k1` on the given heatmap and settings (`tile` None: `r`)."""
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.ops.cuda_nms import nms_tile_keys, nms_tile_keys_torch

    B, H, W = hm.shape
    dtype = hm.dtype
    before = dict(_build.launch_counts)
    got = nms_tile_keys(hm, conf, r, it, border, tile)
    branch = [k for k, n in _build.launch_counts.items() if n != before.get(k, 0)]
    ref = nms_tile_keys_torch(hm, conf, r, it, border, tile)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        n_bad = int((got != ref).sum())
        raise AssertionError(f"K1 {dtype} keys differ from the plain version in {n_bad} tiles")
    ms = cuda_ms(lambda: nms_tile_keys(hm, conf, r, it, border, tile), reps)
    kernel_ms = graph_ms(lambda: nms_tile_keys(hm, conf, r, it, border, tile))
    plain_ms = cuda_ms(lambda: nms_tile_keys_torch(hm, conf, r, it, border, tile),
                       max(reps // 4, 3))
    bound_ms, bound_by = nms_bound(hm, got, r, it)
    return {
        "kernel": "nms_tile_keys", "shape": [B, H, W], "dtype": str(dtype).split(".")[-1],
        "radius": r, "branch": branch[0],
        "survivors": int((ref > 0).sum()), "max_abs_err": int((got - ref).abs().max()),
        "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
    }


def check_k6(gen, B, H, W, dtype, radius, reps):
    """K6, the suppressed map, against its plain version: bit-equal; times
    as `check_k1`."""
    from yolopoint_tpu_torch.ops.cuda_nms import nms_suppressed_map, nms_suppressed_map_torch

    conf, it, border = 0.015, 3, 4
    hm = heatmap_batch(gen, B, H, W, dtype)
    got = nms_suppressed_map(hm, conf, radius, it, border)
    ref = nms_suppressed_map_torch(hm, conf, radius, it, border)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        n_bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        raise AssertionError(f"K6 {dtype} {(B, H, W)} r={radius}: {n_bad} pixels differ")
    ms = cuda_ms(lambda: nms_suppressed_map(hm, conf, radius, it, border), reps)
    kernel_ms = graph_ms(lambda: nms_suppressed_map(hm, conf, radius, it, border))
    plain_ms = cuda_ms(lambda: nms_suppressed_map_torch(hm, conf, radius, it, border),
                       max(reps // 4, 3))
    bound_ms, bound_by = nms_bound(hm, got, radius, it)
    return {
        "kernel": "K6", "shape": [B, H, W], "dtype": str(dtype).split(".")[-1],
        "radius": radius, "survivors": int((ref > 0).sum()),
        "max_abs_err": float((got - ref).abs().max()), "ms": ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": bound_ms / kernel_ms,
    }


# kernel, B, H, W, dtype, radius: launches that no block interior fits (3
# iterations), which take the global-memory branch; K1's tile is the radius
LARGE_RADIUS_INPUTS = (
    ("K6", 16, 640, 640, torch.float32, 15),
    ("K1", 16, 660, 660, torch.bfloat16, 22),
    ("K6", 1, 64, 64, torch.float32, 60),
)


def check_large_radius(gen, kernel, B, H, W, dtype, radius):
    """K1 keys or a K6 map through the global-memory branch, bit-equal to
    the plain version; the launch must count under the branch's own key."""
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.ops.cuda_nms import (nms_suppressed_map, nms_suppressed_map_torch,
                                                  nms_tile_keys, nms_tile_keys_torch)

    conf, it, border = 0.015, 3, 4
    hm = heatmap_batch(gen, B, H, W, dtype)
    hm[:, H // 2, W // 2] = 1.0  # above every drawn peak: at least one survivor at any radius
    if kernel == "K1":
        key = "nms_tile_keys_global"

        def fn():
            return nms_tile_keys(hm, conf, radius, it, border, radius)

        def plain():
            return nms_tile_keys_torch(hm, conf, radius, it, border, radius)
    else:
        key = "K6_global"

        def fn():
            return nms_suppressed_map(hm, conf, radius, it, border)

        def plain():
            return nms_suppressed_map_torch(hm, conf, radius, it, border)
    before = _build.launch_counts[key]
    got = fn()
    if _build.launch_counts[key] - before != 1:
        raise AssertionError(f"{kernel} r={radius}: the global branch did not count a launch")
    ref = plain()
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        n_bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        raise AssertionError(f"{kernel} {dtype} {(B, H, W)} r={radius}: {n_bad} values differ")
    survivors = int((ref > 0).sum())
    if survivors == 0:
        raise AssertionError(f"{kernel} r={radius}: nothing survived")
    kernel_ms = graph_ms(fn, count=5, reps=3)
    bound_ms, bound_by = nms_bound(hm, got, radius, it)
    return {
        "kernel": kernel, "branch": key, "shape": [B, H, W], "dtype": str(dtype).split(".")[-1],
        "radius": radius, "survivors": survivors, "max_abs_err": 0,
        "ms": cuda_ms(fn, 5), "kernel_ms": kernel_ms,
        "plain_ms": cuda_ms(plain, 1, warmup=0), "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": bound_ms / kernel_ms,
    }


def nms_boxes(gen, B, K):
    """Random boxes as in the JAX package's box-NMS tests; the last image is
    an overlapping chain (greedy keeps every other box)."""
    dev = gen.device
    ctr = torch.rand(B, K, 2, generator=gen, device=dev) * 640
    wh = torch.rand(B, K, 2, generator=gen, device=dev) * 145 + 5
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    valid = torch.rand(B, K, generator=gen, device=dev) < 0.85
    x = torch.arange(K, dtype=torch.float32, device=dev) * 3.0  # neighbours: IoU 0.54
    boxes[-1] = torch.stack([x, torch.zeros_like(x), x + 10.0, torch.full_like(x, 10.0)], -1)
    valid[-1] = True
    return boxes.contiguous(), valid


def k2_bound(tiles) -> tuple[float, str]:
    """K2's bound over `(boxes, valid, thr)` inputs: the boxes, validity and
    keep mask once each (bytes), against one IoU and compare (14 operations)
    for each pair of valid boxes of an image, the pairs this data needs."""
    n_bytes = n_ops = 0
    for boxes, valid, _ in tiles:
        n_bytes += boxes.numel() * 4 + 2 * valid.numel()
        nv = valid.sum(dim=1).double()
        n_ops += float((nv * (nv - 1) / 2).sum()) * 14
    return bound(n_bytes, n_ops)


def check_k2(gen, B, K, reps):
    """K2 on random boxes (the last image an overlapping chain) against its
    plain version: equal. `ms` the wrapper between two events, `kernel_ms`
    its launches alone under a CUDA graph."""
    from yolopoint_tpu_torch.ops.cuda_box_nms import greedy_nms_keep, greedy_nms_keep_torch

    iou = 0.45
    boxes, valid = nms_boxes(gen, B, K)
    got = greedy_nms_keep(boxes, valid, iou)
    ref = greedy_nms_keep_torch(boxes, valid, iou)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"K2 keep masks differ at K={K}: {int((got != ref).sum())} boxes")
    if not ref[-1, 0::2].all() or ref[-1, 1::2].any():
        raise AssertionError("K2 chain image: greedy must keep exactly the even boxes")
    ms = cuda_ms(lambda: greedy_nms_keep(boxes, valid, iou), reps)
    kernel_ms = graph_ms(lambda: greedy_nms_keep(boxes, valid, iou))
    plain_ms = cuda_ms(lambda: greedy_nms_keep_torch(boxes, valid, iou), 3, warmup=1)
    bound_ms, bound_by = k2_bound([(boxes, valid, iou)])
    return {
        "kernel": "greedy_nms_keep", "shape": [B, K], "kept": int(ref.sum()),
        "valid": int(valid.sum()), "max_abs_err": int((got.int() - ref.int()).abs().max()),
        "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
    }


def step_agent(cfg, loader, val_loader=None, seed: int = 0, device: str = "cuda"):
    """A `TrainAgent` for the phases that drive its steps directly, in a
    temporary run directory that is removed when the agent goes."""
    from yolopoint_tpu_torch.training import TrainAgent

    run_dir = tempfile.mkdtemp(prefix="yolopoint_run_")
    agent = TrainAgent(cfg, run_dir, loader, val_loader, seed=seed, device=device)
    weakref.finalize(agent, shutil.rmtree, run_dir, ignore_errors=True)
    return agent


def record_val_tiles(seed: int, device: str = "cuda") -> list:
    """The `(boxes, valid, iou_thres)` inputs of every K2 launch of one
    `TrainAgent.validate` batch (the val phase's config, weights and first
    batch): the tiles of the box-NMS scan, recorded by wrapping the name
    `greedy_nms_keep` in `yolopoint_tpu_torch.ops.nms` for that batch."""
    from yolopoint_tpu_torch.ops import nms as nms_module

    cfg = s640_train_config()
    B, (H, W) = cfg["training_params"]["val_batch_size"], cfg["data"]["preprocessing"]["resize"]
    loader = SeededBatches(seed + 4, B, H, W, len(cfg["names"]), B, device, distinct=1)
    agent = step_agent(cfg, loader, loader.batches[:1], seed=seed, device=device)
    tiles, real = [], nms_module.greedy_nms_keep

    def recording(boxes, valid, iou_thres):
        tiles.append((boxes.clone(), valid.clone(), float(iou_thres)))
        return real(boxes, valid, iou_thres)

    nms_module.greedy_nms_keep = recording
    try:
        agent.validate()
    finally:
        nms_module.greedy_nms_keep = real
    torch.cuda.synchronize()
    return tiles


def check_k2_tiles(tiles, reps: int = 5):
    """K2 on the tiles of one val batch (`record_val_tiles`): each keep mask
    equal to the plain version's; times for all tiles, per tile."""
    from yolopoint_tpu_torch.ops.cuda_box_nms import greedy_nms_keep, greedy_nms_keep_torch

    def run(fn):
        return [fn(b, v, t) for b, v, t in tiles]

    for i, (got, ref) in enumerate(zip(run(greedy_nms_keep), run(greedy_nms_keep_torch))):
        if not torch.equal(got, ref):
            raise AssertionError(f"K2 val tile {i}: {int((got != ref).sum())} boxes differ")
    n = len(tiles)
    nv = torch.stack([v.sum(dim=1) for _, v, _ in tiles]).cpu()  # (tiles, B)
    bound_ms, bound_by = k2_bound(tiles)
    kernel_ms = graph_ms(lambda: run(greedy_nms_keep), count=2) / n
    return {
        "kernel": "greedy_nms_keep", "input": "val tiles", "shape": list(tiles[0][1].shape),
        "tiles": n, "tiles_with_valid": int((nv.sum(dim=1) > 0).sum()),
        "valid": int(nv.sum()), "valid_per_image_max": int(nv.max()),
        "iou_thres": tiles[0][2], "max_abs_err": 0,
        "ms": cuda_ms(lambda: run(greedy_nms_keep), reps) / n, "kernel_ms": kernel_ms,
        "kernel_ms_all_tiles": kernel_ms * n,
        "plain_ms": cuda_ms(lambda: run(greedy_nms_keep_torch), 1, warmup=0) / n,
        "bound_ms": bound_ms / n, "bound_by": bound_by, "bound_share": bound_ms / n / kernel_ms,
    }


def check_k3(gen, B, dtype, reps, Hc=80, Wc=80, D=128, N=1000):
    """K3 on a `(B, Hc, Wc, D)` map at N points against its plain version
    (within 1e-5); `kernel_ms` as K2's, and `library_ms` for `F.grid_sample`
    + `F.normalize` on the same inputs."""
    cell = 8
    dev = gen.device
    desc = torch.randn(B, Hc, Wc, D, generator=gen, device=dev)
    desc = (desc / desc.norm(dim=-1, keepdim=True)).to(dtype)
    xm, ym = Wc * cell - 1.0, Hc * cell - 1.0
    pts = torch.rand(B, N, 2, generator=gen, device=dev) * torch.tensor([xm, ym], device=dev)
    pts[:, :4] = torch.tensor([[0.0, 0.0], [xm, ym], [xm - 2.5, 3.0], [2.0, ym - 1.1]],
                              device=dev)  # corners and edges: taps outside the map
    return check_k3_on(desc, pts, cell, reps)


def k3_library(desc, pts, cell):
    """K3's yardstick on the same inputs: `F.grid_sample` (align corners,
    zeros outside) on the NCHW view of the map, in f32, then `F.normalize`."""
    import torch.nn.functional as F

    B, Hc, Wc, D = desc.shape
    grid = torch.stack([pts[..., 0] / (Wc * cell / 2.0) - 1.0,
                        pts[..., 1] / (Hc * cell / 2.0) - 1.0], dim=-1)[:, None]

    def lib():
        x = F.grid_sample(desc.float().permute(0, 3, 1, 2), grid, mode="bilinear",
                          padding_mode="zeros", align_corners=True)
        return F.normalize(x[:, :, 0].permute(0, 2, 1), dim=-1)
    return lib


def k3_bytes(desc, pts, cell) -> int:
    """The bytes K3 must move: the distinct map pixels the points tap, the
    points and the (B, N, D) f32 output."""
    B, Hc, Wc, D = desc.shape
    N = pts.shape[1]
    cx = ((pts[..., 0] / (Wc * cell / 2.0) - 1.0 + 1.0) * 0.5 * (Wc - 1)).floor().long()
    cy = ((pts[..., 1] / (Hc * cell / 2.0) - 1.0 + 1.0) * 0.5 * (Hc - 1)).floor().long()
    taps = set()
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = cx + dx, cy + dy
            ok = (x >= 0) & (x < Wc) & (y >= 0) & (y < Hc)
            lin = torch.arange(B, device=desc.device)[:, None] * Hc * Wc + y * Wc + x
            taps.update(lin[ok].tolist())
    return len(taps) * D * desc.element_size() + pts.numel() * 4 + B * N * D * 4


def k3_bound(desc, pts, cell) -> tuple[float, str]:
    """K3's bound: `k3_bytes` against 14 operations a channel (the 4-tap
    blend, the square-sum, the scale)."""
    B, _, _, D = desc.shape
    return bound(k3_bytes(desc, pts, cell), B * pts.shape[1] * D * 14)


def k3_memory_ms(desc, pts, cell, run=None) -> float:
    """Milliseconds a launch of K3 (`run(desc, pts)`, by default the wrapper)
    with its bytes moved to and from memory, as its bound counts them:
    `graph_ms` over launches that cycle through copies of the map and the
    points, enough copies that a copy's taps have left the L2 before it
    comes round again, each launch writing an output of its own. (One input
    replayed stays in the 50 MB L2, and its time can beat the bound.)"""
    from yolopoint_tpu_torch.ops.cuda_gather import sample_descriptors_cuda

    run = run or (lambda d, p: sample_descriptors_cuda(d, p, cell))
    l2 = getattr(torch.cuda.get_device_properties(desc.device), "L2_cache_size", 50 << 20)
    size = desc.numel() * desc.element_size() + pts.numel() * 4 * (1 + desc.shape[3])
    copies = min(max(2, -(-3 * l2 // k3_bytes(desc, pts, cell))), max(2, (4 << 30) // size))
    inputs = [(desc.clone(), pts.clone()) for _ in range(copies)]
    outs, turn = [], iter(range(1 << 30))

    def launch():
        outs.append(run(*inputs[next(turn) % copies]))
    return graph_ms(launch, count=max(20, copies))


def check_k3_on(desc, pts, cell, reps):
    """`check_k3` on the given map and points."""
    from yolopoint_tpu_torch.ops.cuda_gather import sample_descriptors_cuda, sample_descriptors_torch

    B, Hc, Wc, D = desc.shape
    N = pts.shape[1]
    dtype = desc.dtype
    got = sample_descriptors_cuda(desc, pts, cell)
    ref = sample_descriptors_torch(desc, pts, cell)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"K3 {dtype} {tuple(desc.shape)}: max abs error {err} > 1e-5")
    ms = cuda_ms(lambda: sample_descriptors_cuda(desc, pts, cell), reps)
    kernel_ms = k3_memory_ms(desc, pts, cell)
    kernel_l2_ms = graph_ms(lambda: sample_descriptors_cuda(desc, pts, cell))
    plain_ms = cuda_ms(lambda: sample_descriptors_torch(desc, pts, cell), max(reps // 4, 3))
    lib = k3_library(desc, pts, cell)
    library_err = float((lib() - ref).abs().max())
    if not library_err <= 1e-5:
        raise AssertionError(f"K3 {dtype}: F.grid_sample + F.normalize off by {library_err} > 1e-5")
    library_ms = cuda_ms(lib, reps)
    bound_ms, bound_by = k3_bound(desc, pts, cell)
    return {
        "kernel": "sample_descriptors", "shape": [B, Hc, Wc, D, N],
        "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
        "ms": ms, "kernel_ms": kernel_ms, "kernel_l2_ms": kernel_l2_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "library_max_abs": library_err, "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
    }


def check_k3_instantiations(gen) -> dict:
    """Every instantiation of K3's kernel through its wrapper, on a (2, 20,
    24, D) map of each dtype at N = 203 (a multiple of no block's points)
    against the plain version, within 1e-5: each family width's own, and the
    generic one at D = 100 and at D = 128 on a map whose base is not aligned
    to a vector."""
    from yolopoint_tpu_torch.ops.cuda_gather import sample_descriptors_cuda, sample_descriptors_torch

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for D, offset in [(64, 0), (128, 0), (192, 0), (256, 0), (320, 0), (100, 0), (128, 1)]:
            flat = torch.randn(2 * 20 * 24 * D + offset, generator=gen, device=gen.device)
            desc = flat.to(dtype)[offset:].view(2, 20, 24, D)
            pts = torch.rand(2, 203, 2, generator=gen, device=gen.device) * 200 - 4
            got = sample_descriptors_cuda(desc, pts, 8)
            ref = sample_descriptors_torch(desc, pts, 8)
            torch.cuda.synchronize()
            errs[f"{str(dtype)[6:]} D={D}{' unaligned' if offset else ''}"] = \
                float((got - ref).abs().max())
    bad = {k: e for k, e in errs.items() if not e <= 1e-5}
    if bad:
        raise AssertionError(f"K3 instantiations off by more than 1e-5: {bad}")
    return {"kernel": "sample_descriptors", "input": "every instantiation",
            "cases": len(errs), "max_abs_err": max(errs.values()), "errors": errs}


WARP_HOMOGRAPHIC = {  # configs/synthetic_s640.yaml, data.augmentation.homographic.params
    "perspective": True, "scaling": True, "rotation": True, "translation": True,
    "patch_ratio": 0.85, "perspective_amplitude_x": 0.2, "perspective_amplitude_y": 0.2,
    "scaling_amplitude": 0.2, "max_angle": 1.57,
}


def warp_pixels_read(hom, B, H, W, mode) -> int:
    """The distinct in-frame source pixels that the warp's taps read (four
    bilinear taps or one nearest tap per output pixel), from the plain
    version's source coordinates."""
    from yolopoint_tpu_torch.ops import geometry

    sx, sy = geometry._source_pixels(hom, H, W, B)
    if mode == "nearest":
        x0, y0, offsets = torch.floor(sx + 0.5), torch.floor(sy + 0.5), ((0, 0),)
    else:
        x0, y0, offsets = torch.floor(sx), torch.floor(sy), ((0, 0), (1, 0), (0, 1), (1, 1))
    read = torch.zeros(B * H * W, dtype=torch.bool, device=hom.device)
    base = torch.arange(B, device=hom.device)[:, None, None] * (H * W)
    for dx, dy in offsets:
        x, y = x0 + dx, y0 + dy
        ok = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)  # False for NaN
        lin = base + torch.where(ok, y * W + x, 0.0).long()
        read[lin[ok]] = True
    return int(read.sum())


EXPORT_HOMOGRAPHIC = {  # configs/synthetic_s640_export.yaml, export.homography
    "perspective": True, "scaling": True, "rotation": True, "translation": True,
    "patch_ratio": 0.85,
}
EXPORT_CONFIGS = {"kitti": "kitti_export.yaml", "coco": "coco_export.yaml"}


def export_config(name: str) -> dict:
    """`configs/kitti_export.yaml` or `configs/coco_export.yaml` (`name`
    `kitti` or `coco`), read by the port's config reader."""
    from yolopoint_tpu_torch.utils.config import load_config

    return load_config(REPO / "configs" / EXPORT_CONFIGS[name])


def warp_homographies(gen, kind: str, B: int) -> torch.Tensor:
    """Output -> source homographies for a warp check input:
      s640            sampled as the s640 augmentation samples them;
      single          one such (3, 3) homography, which the wrapper expands;
      export_forward  the export's views: the identity, then B - 1 draws
                      with its parameters;
      export_inverse  their inverses: the warps that bring the export's N
                      heatmaps and masks back, which zoom out;
      zoom_out        those inverses after a 3x zoom-out of the output, so
                      that inner tiles' windows exceed the shared budget;
      kitti_forward, kitti_inverse, coco_forward, coco_inverse
                      the same pair at the homography parameters of
                      `configs/kitti_export.yaml` / `configs/coco_export.yaml`;
      sign_change     w2 = 0.6 x + 0.3 y + 0.2 (then an s640 homography)
                      crosses zero inside the frame, and taps near the line
                      fly across it;
      kitti_crop      `configs/kitti.yaml`'s H1 conjugated by random 288x896
                      crops of the 320x960 frame (the train views' warps);
      kitti_mosaic    its mosaic H1 conjugated by the centre crop of the
                      576x1792 canvas (the mosaic views and the canvas mask);
      kitti_pair      its H2 (the nearest warp of the base mask in the crop);
      kitti_pair_inverse
                      H2's inverse (the descriptor loss's cell mask)."""
    from yolopoint_tpu_torch.ops.homography import sample_homography_batch

    dev = gen.device
    if kind.startswith("kitti_") and kind[6:] in ("crop", "mosaic", "pair", "pair_inverse"):
        from yolopoint_tpu_torch.data.augmentation import crop_conjugate_homography

        aug = kitti_train_config()["data"]["augmentation"]
        hom, pair = aug["homographic"], aug["warped_pair"]
        if kind == "kitti_crop":
            crop = torch.stack([torch.randint(0, 320 - KITTI_VIEW[0] + 1, (B,), generator=gen,
                                              device=dev),
                                torch.randint(0, 960 - KITTI_VIEW[1] + 1, (B,), generator=gen,
                                              device=dev)], 1).float()
            h = sample_homography_batch(gen, B, **hom["params"])
            return crop_conjugate_homography(h, crop, KITTI_VIEW, (320, 960)).contiguous()
        if kind == "kitti_mosaic":
            crop = torch.tensor([[144.0, 448.0]] * B, device=dev)
            h = sample_homography_batch(gen, B, **hom["mosaic"]["params"])
            return crop_conjugate_homography(h, crop, KITTI_VIEW, (576, 1792)).contiguous()
        h2 = sample_homography_batch(gen, B, **pair["params"])
        return h2 if kind == "kitti_pair" else torch.linalg.inv(h2).contiguous()
    if kind == "s640":
        return sample_homography_batch(gen, B, **WARP_HOMOGRAPHIC)
    if kind == "single":
        return sample_homography_batch(gen, 1, **WARP_HOMOGRAPHIC)[0]
    config, _, direction = kind.partition("_")
    if config in EXPORT_CONFIGS and direction in ("forward", "inverse"):
        params = export_config(config)["export"]["homography"]
        views = sample_homography_batch(gen, B - 1, **params)
        views = torch.cat([torch.eye(3, device=dev)[None], views]).contiguous()
        return views if direction == "forward" else torch.linalg.inv(views).contiguous()
    if kind in ("export_forward", "export_inverse", "zoom_out"):
        views = sample_homography_batch(gen, B - 1, **EXPORT_HOMOGRAPHIC)
        views = torch.cat([torch.eye(3, device=dev)[None], views])
        if kind == "export_forward":
            return views.contiguous()
        inv = torch.linalg.inv(views)
        if kind == "zoom_out":
            inv = inv @ torch.diag(torch.tensor([3.0, 3.0, 1.0], device=dev))
        return inv.contiguous()
    if kind == "sign_change":
        tilt = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.6, 0.3, 0.2]], device=dev)
        return (sample_homography_batch(gen, B, **WARP_HOMOGRAPHIC) @ tilt).contiguous()
    raise ValueError(kind)


def graph_ms(fn, count: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of `fn` on the device alone: `count` calls
    captured in one CUDA graph, replayed `reps` times, median per call."""
    fn()  # first-call allocations and caches outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    del graph
    return statistics.median(times)


def check_warp(gen, B, H, W, C, mode, reps, homs="s640"):
    """The warp kernel against its plain version on (B, H, W, C) f32 images
    in [0, 1) and the homographies `homs` of `warp_homographies`.

    Gates: nearest bit-equal, bilinear within 1e-5, NaN (a pixel whose
    coordinates are not finite, bilinear) at the same pixels; the tiles the
    kernel's counter saw take the global branch equal to those whose window,
    from the plain version's coordinates (`window_bytes`), exceeds the
    shared budget. `ms` times `warp_image_cuda` (argument checks, the
    homographies made contiguous, the launch); `kernel_ms` the launches
    alone (`graph_ms`); `plain_ms` the plain version; `library_ms`
    `F.grid_sample` (NCHW input, zeros, align_corners=True, the same mode)
    with the normalized source grid precomputed, and `library_kernel_ms`
    the same under a graph. Its nearest mode rounds ties to even where the
    warp rounds half up, so there it computes nearly, not exactly, the same
    function: `library_differing_pixels` counts where it differs."""
    img = torch.rand(B, H, W, C, generator=gen, device=gen.device)
    return check_warp_on(img, warp_homographies(gen, homs, B), mode, reps, homs)


def check_warp_on(img, hom, mode, reps, homs):
    """`check_warp` on the given images and homographies (`homs` names
    them in the line)."""
    import torch.nn.functional as F

    from yolopoint_tpu_torch.ops import cuda_warp, geometry

    B, H, W, C = img.shape
    what = f"warp {mode} {(B, H, W, C)} {homs}"
    before = cuda_warp.global_tile_count(img.device)
    got = cuda_warp.warp_image_cuda(img, hom, mode)
    global_tiles = cuda_warp.global_tile_count(img.device) - before
    ref = geometry.warp_image_plain(img, hom, mode)
    torch.cuda.synchronize()
    nan = ref.isnan()
    if not torch.equal(got.isnan(), nan):
        raise AssertionError(f"{what}: NaN at other pixels than the plain version")
    err = float(torch.where(nan, 0.0, (got - ref).abs()).max())
    n_diff = int(((got != ref) & ~nan).any(-1).sum())
    if mode == "nearest" and n_diff:
        raise AssertionError(f"{what}: {n_diff} pixels differ from the plain version")
    if not err <= 1e-5:
        raise AssertionError(f"{what}: max abs error {err} > 1e-5")
    tx, ty = cuda_warp.tile_grid(H, W)
    tiles = B * tx * ty
    window = cuda_warp.window_bytes(hom, img.shape, mode)
    expected = int((window > cuda_warp.WINDOW_BYTES).sum())
    if global_tiles != expected:
        raise AssertionError(f"{what}: {global_tiles} tiles took the global branch, "
                             f"the windows say {expected}")
    hom_c = hom.reshape(-1, 3, 3).expand(B, 3, 3).contiguous()
    ms = cuda_ms(lambda: cuda_warp.warp_image_cuda(img, hom, mode), reps)
    kernel_ms = graph_ms(lambda: cuda_warp._launch(img, hom_c, mode))
    plain_ms = cuda_ms(lambda: geometry.warp_image_plain(img, hom, mode), 3, warmup=1)
    src = geometry.warp_points(geometry._normalized_grid(H, W, img.device).reshape(-1, 2), hom)
    grid = src.reshape(B, H, W, 2)
    x = img.permute(0, 3, 1, 2).contiguous()

    def lib():
        return F.grid_sample(x, grid, mode=mode, padding_mode="zeros", align_corners=True)

    lib_diff = torch.where(nan, 0.0, (lib().permute(0, 2, 3, 1) - ref).abs())
    library_err = float(lib_diff.max())
    library_err = library_err if math.isfinite(library_err) else None
    library_differing = int((lib_diff > 1e-5).any(-1).sum())
    del lib_diff
    library_ms = cuda_ms(lib, reps)
    library_kernel_ms = graph_ms(lib)
    # bytes: the distinct source pixels the taps read, the output, the
    # homographies and the grid axes
    n_read = warp_pixels_read(hom, B, H, W, mode)
    n_bytes = n_read * C * 4 + got.numel() * 4 + hom_c.numel() * 4 + (H + W) * 4
    n_ops = B * H * W * (20 + (12 + 9 * C if mode == "bilinear" else 4))
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {
        "kernel": "K5" if cuda_warp.warp_fits_pallas(img.shape) else "K4", "shape": [B, H, W, C],
        "mode": mode, "homographies": homs, "max_abs_err": err, "differing_pixels": n_diff,
        "nan_pixels": int(nan.any(-1).sum()), "ms": ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "library_kernel_ms": library_kernel_ms,
        "library_max_abs": library_err, "library_differing_pixels": library_differing,
        "source_read_share": n_read / (B * H * W),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
        "tiles": tiles, "global_tiles": global_tiles, "global_tile_share": global_tiles / tiles,
        "window_kb_max": int(window.max()) / 1024,
    }


# B, H, W, C, mode, homographies, the path whose warp this is (None: no
# path): the K4 and K5 shapes of the train path, the three warps of each
# export (the views at C = 3, the heatmaps and masks back at C = 1: the s640
# export, KITTI's N = 10 at 320x960, COCO's N = 100 at 480x640, the export
# CLI's N = 50 at 256x320, where the warp counts as K5), the KITTI fine-tune's
# (B = 16: crop views, mosaic views and canvas mask, the pair mask, the
# descriptor loss's cell mask), two more of
# each mode, and inputs that force each branch and edge (global branch, w2
# sign change, ragged tiles, W * C not a multiple of 4, C = 2 and 4, one
# (3, 3) homography)
WARP_INPUTS = (
    (32, 640, 640, 3, "bilinear", "s640", "train"),
    (32, 80, 80, 1, "nearest", "s640", "train"),
    (50, 640, 640, 3, "bilinear", "export_forward", "export"),
    (50, 640, 640, 1, "bilinear", "export_inverse", "export"),
    (10, 320, 960, 3, "bilinear", "kitti_forward", "export_kitti"),
    (10, 320, 960, 1, "bilinear", "kitti_inverse", "export_kitti"),
    (100, 480, 640, 3, "bilinear", "coco_forward", "export_coco"),
    (100, 480, 640, 1, "bilinear", "coco_inverse", "export_coco"),
    (50, 256, 320, 3, "bilinear", "export_forward", "export_cli"),  # K5's shape in the gate
    (50, 256, 320, 1, "bilinear", "export_inverse", "export_cli"),
    (16, 320, 960, 3, "bilinear", "kitti_crop", "fit_kitti"),  # the crop's views
    (16, 576, 1792, 3, "bilinear", "kitti_mosaic", "fit_kitti"),  # the mosaic's views
    (16, 576, 1792, 1, "nearest", "kitti_mosaic", "fit_kitti"),  # the canvas mask
    (16, 288, 896, 1, "nearest", "kitti_pair", "fit_kitti"),  # the pair mask
    (16, 36, 112, 1, "nearest", "kitti_pair_inverse", "fit_kitti"),  # the loss's cell mask (K4)
    (50, 640, 640, 1, "bilinear", "export_forward", None),
    (8, 240, 320, 3, "bilinear", "s640", None),
    (32, 640, 640, 1, "nearest", "s640", None),
    (8, 640, 640, 3, "bilinear", "zoom_out", None),
    (4, 640, 640, 3, "bilinear", "sign_change", None),
    (4, 640, 640, 3, "nearest", "sign_change", None),
    (3, 101, 94, 4, "bilinear", "s640", None),
    (3, 101, 94, 4, "nearest", "s640", None),
    (1, 37, 53, 2, "bilinear", "single", None),
    (1, 37, 53, 2, "nearest", "single", None),
)


def check_warps(gen, reps: int = 20) -> list[dict]:
    """Every warp input of `WARP_INPUTS`, one line each (with the launches
    the check made and its `path`); fails if the train path's K4 input
    sends more than 5% of its tiles to the global branch, or the zoom-out
    input none (the export's shares are reported, not gated)."""
    from yolopoint_tpu_torch.ops import _build

    lines = []
    for B, H, W, C, mode, homs, path in WARP_INPUTS:
        before = sum(_build.launch_counts.values())
        line = check_warp(gen, B, H, W, C, mode, reps, homs)
        line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
        line["path"] = path
        lines.append(line)
        if path == "train" and line["kernel"] == "K4" and line["global_tile_share"] > 0.05:
            raise AssertionError(f"warp {(B, H, W, C)} {homs}: {line['global_tile_share']:.3f} "
                                 "of the tiles took the global branch (> 0.05)")
        if homs == "zoom_out" and line["global_tiles"] == 0:
            raise AssertionError("warp zoom-out input: no tile took the global branch")
    return lines


# ---------------------------------------------------------------- model


@torch.no_grad()
def random_weights(model: torch.nn.Module, seed: int) -> dict:
    """Seeded random weights: conv kernels uniform in +-1/sqrt(fan_in), and
    so are the biases of convolutions outside the Detect head (whose prior
    biases stay), BatchNorm affine and running statistics away from the
    identity."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)

    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            b = mod.weight[0].numel() ** -0.5
            uniform(mod.weight, -b, b)
            if mod.bias is not None and not name.startswith("Detect."):
                uniform(mod.bias, -b, b)
        elif isinstance(mod, torch.nn.BatchNorm2d):
            uniform(mod.weight, 0.5, 1.5)
            uniform(mod.bias, -0.3, 0.3)
            uniform(mod.running_mean, -0.5, 0.5)
            uniform(mod.running_var, 0.5, 2.0)
    return model.state_dict()


def raise_detect_biases(model, state: dict, detect_bias: float) -> dict:
    """`state` (of `model`) with the Detect head's objectness and class
    biases raised by `detect_bias` above their priors."""
    for i in range(model.Detect.nl):
        state[f"Detect.m.{i}.bias"].view(model.Detect.na, model.Detect.no)[:, 4:] += detect_bias
    return state


def folded_model(name: str, version: str, seed: int, dtype, device, nc: int = 80,
                 detect_bias: float = 0.0):
    """`name` at `version` with seeded random weights, BN folded (a family
    without BN, `SuperPointNet`, as it is), the Detect biases raised by
    `detect_bias`, in `dtype` on `device`."""
    from yolopoint_tpu_torch.models import build_model, fold_batch_norm

    plain = build_model(name, version, nc=nc, device="cpu")
    state = random_weights(plain, seed)
    if detect_bias:
        raise_detect_biases(plain, state, detect_bias)
    model = build_model(name, version, nc=nc, fused=True, device="cpu")
    model.load_state_dict(fold_batch_norm(state))
    return model.to(device=device, dtype=dtype).eval()


def folded_yolopoint_s(seed: int, dtype, device, nc: int = 80, detect_bias: float = 0.0):
    return folded_model("YOLOPoint", "s", seed, dtype, device, nc, detect_bias)


def same_points(a_pts, a_valid, b_pts, b_valid) -> bool:
    a = sorted(map(tuple, a_pts[a_valid].tolist()))
    b = sorted(map(tuple, b_pts[b_valid].tolist()))
    return a == b


def same_detections(det_g: dict, det_c: dict, what: str, atol: float) -> dict:
    """Card and CPU detections of the same inputs, slot by slot: the same
    valid slots (more than 0), classes equal, coordinates within `atol`."""
    det_g = {k: v.cpu() for k, v in det_g.items()}
    ok = det_c["valid"]
    if not torch.equal(det_g["valid"], ok) or not bool(ok.any()):
        raise AssertionError(f"{what}: detections card {det_g['valid'].sum(1).tolist()} "
                             f"vs CPU {ok.sum(1).tolist()}")
    err = float((det_g["boxes"][ok] - det_c["boxes"][ok]).abs().max())
    if not torch.equal(det_g["classes"][ok], det_c["classes"][ok]) or not err <= atol:
        raise AssertionError(f"{what}: classes differ or coordinates by {err} > {atol}")
    return {"boxes_compared": int(ok.sum()), "per_image": ok.sum(1).tolist(),
            "box_max_abs": err}


@torch.inference_mode()
def check_reference(seed: int, device: str = "cuda"):
    """f32 YOLOPoint-S on one 256x256 frame: the forward on the card against
    the CPU (TF32 off), then each decode stage on the card (kernels) against
    the CPU (plain versions) on the same inputs, copied from the card: boxes
    at the serving gate 0.25 (nc=80) and at 0.001 (the s640 model, nc=5,
    where boxes pass with random weights; box NMS of the card's decoded
    predictions), and keypoints at radii 3 and 7 (no tile divides 256: K6)."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.models.detect import decode_levels
    from yolopoint_tpu_torch.ops import (_build, batched_box_nms, cells_to_heatmap,
                                         extract_keypoints, fused_detect_nms, sample_descriptors)

    cfg = dict(SERVE_CONFIG, heatmap_dtype="f32")
    gpu = InferencePipeline(folded_yolopoint_s(seed, torch.float32, device), cfg, device=device)
    cpu = InferencePipeline(folded_yolopoint_s(seed, torch.float32, "cpu"), cfg, device="cpu")
    img = torch.randint(0, 256, (1, 256, 256, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(seed + 1))
    out_g = gpu.forward(img.to(device))
    out_c = cpu.forward(img)
    fwd_err = {
        "semi": float((out_g["semi"].cpu() - out_c["semi"]).abs().max()),
        "desc": float((out_g["desc"].cpu() - out_c["desc"]).abs().max()),
        "objects": max(float((g.cpu() - c).abs().max())
                       for g, c in zip(out_g["objects"], out_c["objects"])),
    }
    if not max(fwd_err.values()) <= 1e-3:
        raise AssertionError(f"f32 forward, card vs CPU: {fwd_err} above 1e-3")

    heat = cells_to_heatmap(out_g["semi"].permute(0, 2, 3, 1))
    args = (cfg["detection_threshold"], cfg["nms"], cfg["top_k"])
    pts_g, sc_g, ok_g = extract_keypoints(heat, *args)
    pts_c, sc_c, ok_c = extract_keypoints(heat.cpu(), *args)
    if not same_points(pts_g[0].cpu(), ok_g[0].cpu(), pts_c[0], ok_c[0]) or not torch.equal(
            sc_g.cpu().sort(dim=1).values, sc_c.sort(dim=1).values):
        raise AssertionError("keypoints differ between the card and the CPU")
    n_kp = int(ok_c.sum())
    if n_kp == 0:
        raise AssertionError("no keypoints on the reference frame")

    desc = out_g["desc"].permute(0, 2, 3, 1).contiguous()
    desc_err = float((sample_descriptors(desc, pts_g).cpu()
                      - sample_descriptors(desc.cpu(), pts_g.cpu())).abs().max())
    if not desc_err <= 1e-5:
        raise AssertionError(f"descriptors differ by {desc_err} > 1e-5")

    nms_args = (gpu._anchors_ps, gpu._strides, cfg["conf_thresh"], cfg["iou_thresh"],
                cfg["max_det"], cfg["max_nms"])
    det_g = fused_detect_nms(out_g["objects"], *nms_args)
    det_c = fused_detect_nms([o.cpu() for o in out_g["objects"]], *nms_args)
    nb_g, nb_c = int(det_g["valid"].sum()), int(det_c["valid"].sum())
    bg = det_g["boxes"][det_g["valid"]].cpu()
    bc = det_c["boxes"][det_c["valid"]]
    box_err = float((bg.sort(0).values - bc.sort(0).values).abs().max()) if nb_c else 0.0
    if nb_g != nb_c or not box_err <= 1e-3:
        raise AssertionError(f"boxes {nb_g} vs {nb_c}, max coordinate error {box_err}")

    # box gate 0.001 on the s640 model (nc=5): with nc=80 random weights no
    # score on this frame reaches 0.001, while nc=5's class prior puts part
    # of the anchors above it. Both sides get the card's decoded predictions:
    # neighbouring anchors of random weights predict nearly the same box with
    # scores ~1e-10 apart, so the ulp by which the card's sigmoid differs from
    # the CPU's would reorder them and change which survive.
    s640 = InferencePipeline(folded_yolopoint_s(seed, torch.float32, device, nc=5), cfg,
                             device=device)
    pred = decode_levels(s640.forward(img.to(device))["objects"], s640._anchors_ps,
                         s640._strides)
    low_kw = dict(conf_thres=0.001, iou_thres=cfg["iou_thresh"], max_det=cfg["max_det"],
                  max_nms=cfg["max_nms"])
    low = same_detections(batched_box_nms(pred, **low_kw), batched_box_nms(pred.cpu(), **low_kw),
                          "reference nc=5 conf 0.001", 1e-4)

    # the untiled keypoint path (K6): 256 is no multiple of 3 or 7
    untiled = {}
    for r in (3, 7):
        before = _build.launch_counts["K6"]
        got = extract_keypoints(heat, cfg["detection_threshold"], r, cfg["top_k"])
        if _build.launch_counts["K6"] - before != 1:
            raise AssertionError(f"untiled keypoints r={r}: K6 was not launched")
        want = extract_keypoints(heat.cpu(), cfg["detection_threshold"], r, cfg["top_k"])
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"untiled keypoints r={r} differ between the card and the CPU")
        untiled[str(r)] = int(want[2].sum())
        if untiled[str(r)] == 0:
            raise AssertionError(f"untiled keypoints r={r}: none found")
    return {"phase": "reference", "frame": [256, 256], "forward_max_abs": fwd_err,
            "keypoints": n_kp, "descriptor_max_abs": desc_err, "boxes": nb_c,
            "box_candidates": int(det_c["n_candidates"][0]), "box_max_abs": box_err,
            "conf_0.001": low, "untiled_keypoints": untiled}


@torch.inference_mode()
def serve(seed: int, batches=(1, 16), requests=(20, 8), device: str = "cuda"):
    """The benchmark operating point on uint8 640x640 batches."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.ops import _build

    pipe = InferencePipeline(folded_yolopoint_s(seed, torch.bfloat16, device), SERVE_CONFIG,
                             compute_dtype=torch.bfloat16, device=device)
    gen = torch.Generator().manual_seed(seed + 2)
    frames = {B: torch.randint(0, 256, (B, 640, 640, 3), dtype=torch.uint8, generator=gen)
              for B in batches}
    for B in batches:  # warm-up: cuDNN plans, allocator, kernels
        for _ in range(2):
            pipe(frames[B])
    torch.cuda.synchronize()

    _build.launch_counts.clear()
    lat, outs = {}, {}
    for B, n in zip(batches, requests):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            out = pipe(frames[B])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        lat[B], outs[B] = times, out
    launches = dict(_build.launch_counts)

    for B, out in outs.items():
        expect = {"keypoints": (B, 1000, 2), "kp_scores": (B, 1000), "boxes": (B, 300, 4),
                  "box_scores": (B, 300), "descriptors": (B, 1000, 128)}
        for k, shape in expect.items():
            if tuple(out[k].shape) != shape:
                raise AssertionError(f"serve B={B}: {k} has shape {tuple(out[k].shape)}")
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"serve B={B}: {k} is not finite")
        d = out["descriptors"][out["kp_valid"]]
        if d.numel() and not ((d.norm(dim=-1) - 1.0).abs() <= 1e-4).all():
            raise AssertionError(f"serve B={B}: descriptors are not unit vectors")
    for name in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"serve: kernel {name} was not launched on the main path")

    # where one request's time goes, forward vs decode, by CUDA events
    split = {}
    for B in batches:
        x = frames[B].to(device)
        raw = pipe.forward(x)
        split[B] = {"forward_ms": cuda_ms(lambda: pipe.forward(x), 5),
                    "decode_ms": cuda_ms(lambda: pipe.decode(raw), 5)}
    result = {
        "phase": "serve", "model": "YOLOPoint-s", "nc": 80, "input": [640, 640],
        "dtype": "bf16", "config": SERVE_CONFIG, "launches": launches,
        "latency_ms_p50": {str(B): statistics.median(t) for B, t in lat.items()},
        "latency_ms_all": {str(B): t for B, t in lat.items()},
        "images_per_s": {str(B): B * 1e3 / statistics.median(t) for B, t in lat.items()},
        "split_ms": {str(B): s for B, s in split.items()},
        "keypoints_per_image": float(outs[batches[-1]]["kp_valid"].sum(1).float().mean()),
        "boxes_per_image": float(outs[batches[-1]]["box_valid"].sum(1).float().mean()),
        "box_candidates_per_image": float(
            outs[batches[-1]]["box_n_candidates"].float().mean()),
    }
    return result, launches


# ---------------------------------------------------------------- training

def s640_train_config() -> dict:
    """`configs/synthetic_s640.yaml`, read by the port's config reader: the
    training config of the step, val and fit phases."""
    from yolopoint_tpu_torch.utils.config import load_config

    return load_config(REPO / "configs" / "synthetic_s640.yaml")


LOSS_TERMS = ("loss", "loss_det", "loss_desc", "loss_obj", "obj_box", "obj_obj", "obj_cls")


class SeededBatches:
    """Batches shaped as `device_data.build_host_arrays` shapes them, made on
    `device` from a seed: uint8 images, <= `max_points` keypoints and
    <= `max_boxes` boxes per image, with validity masks. `len()` is the
    configured train length over the batch size (micro-steps per epoch)."""

    def __init__(self, seed, B, H, W, nc, length, device, distinct=4, max_points=256,
                 max_boxes=64):
        gen = torch.Generator(device=device).manual_seed(seed)
        self.n = max(length // B, 1)

        def rand(*shape):
            return torch.rand(shape, generator=gen, device=device)

        def counts(high):
            return torch.randint(high // 2, high + 1, (B, 1), generator=gen, device=device)

        self.batches = []
        for _ in range(distinct):
            k = torch.arange(max_points, device=device)[None]
            m = torch.arange(max_boxes, device=device)[None]
            boxes = torch.cat([torch.randint(0, nc, (B, max_boxes, 1), generator=gen,
                                             device=device).float(),
                               rand(B, max_boxes, 2) * 0.6 + 0.2,
                               rand(B, max_boxes, 2) * 0.25 + 0.05], dim=-1)
            self.batches.append({
                "image": torch.randint(0, 256, (B, H, W, 3), generator=gen, device=device,
                                       dtype=torch.uint8),
                "points": rand(B, max_points, 2) * torch.tensor([W - 1.0, H - 1.0], device=device),
                "point_mask": k < counts(max_points),
                "boxes": boxes,
                "box_mask": m < counts(max_boxes),
            })

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            yield self.batches[i % len(self.batches)]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def train_reference(seed: int, device: str = "cuda"):
    """One micro-step of the port's train step in f32 (TF32 off) on the card
    and on the CPU: YOLOPoint-n, 128x128, B=2, the s640 augmentation and
    losses, the same initial weights, batch and pre-drawn random samples
    (drawn once on the CPU). With `accum` 2 the micro-step leaves the
    parameters and fills the optimizer's accumulator with the gradient.
    Gradient norms are held to 1e-3: on the card the backward of the
    descriptor and object losses' gathers are scatter-adds, summed in a
    nondeterministic order."""
    import copy

    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.training import (LossWeights, create_train_state, draw_step,
                                              make_optimizer, make_train_step,
                                              rescale_yolo_gains)
    from yolopoint_tpu_torch.losses import ObjectLossConfig

    cfg = s640_train_config()
    aug = cfg["data"]["augmentation"]
    sp = cfg["model"]["superpoint"]["sparse_loss"]["params"]
    weights = LossWeights(lambda_desc=0.1, lambda_obj=10.0, desc_loss_type="infonce",
                          det_loss_type="ce", num_samples_per_image=sp["num_samples_per_image"],
                          num_masked_non_matches_per_match=sp["num_masked_non_matches_per_match"])
    nc, B, H = len(cfg["names"]), 2, 128
    obj = rescale_yolo_gains(ObjectLossConfig(**{k: cfg["model"]["yolo"][k]
                                                 for k in ("box", "obj", "cls", "anchor_t")}),
                             nc, H)
    torch.manual_seed(seed)
    model_cpu = build_model("YOLOPoint", "n", nc=nc, device="cpu").train()
    batch_cpu = SeededBatches(seed + 1, B, H, H, nc, B, "cpu", distinct=1).batches[0]
    draws_cpu = draw_step(torch.Generator().manual_seed(seed + 2), (B, H, H, 3), aug, weights)

    results = {}
    for dev in ("cpu", device):
        model = copy.deepcopy(model_cpu).to(dev)
        opt = make_optimizer(model, learning_rate=1e-3, lrf=0.1, total_epochs=125,
                             steps_per_epoch=32, grad_clip=10.0, accumulate_steps=2)
        state = create_train_state(model, opt, ema=True)
        step = make_train_step(model, aug, obj, weights, nc, accum=2)
        _build.launch_counts.clear()
        aux = step(state, _to(batch_cpu, dev), _to(draws_cpu, dev))
        if dev != "cpu":
            torch.cuda.synchronize()
        results[dev] = {
            "losses": {k: float(aux[k]) for k in LOSS_TERMS},
            "grad_norms": {n: float(a.norm()) for n, a in zip(opt.names, opt.acc)},
            "launches": dict(_build.launch_counts),
        }
    cpu, gpu = results["cpu"], results[device]
    loss_rel = {k: abs(gpu["losses"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["losses"].items()}
    grad_rel = {n: abs(gpu["grad_norms"][n] - v) / max(v, 1e-12)
                for n, v in cpu["grad_norms"].items() if v > 0}
    worst_grad = max(grad_rel, key=grad_rel.get)
    if not max(loss_rel.values()) <= 1e-4:
        raise AssertionError(f"train_reference: losses card vs CPU {loss_rel} above 1e-4")
    if not grad_rel[worst_grad] <= 1e-3:
        raise AssertionError(f"train_reference: gradient norm of {worst_grad} differs by "
                             f"{grad_rel[worst_grad]} > 1e-3")
    if gpu["launches"].get("K5", 0) != 3 or cpu["launches"]:
        raise AssertionError(f"train_reference: warp launches card {gpu['launches']}, "
                             f"CPU {cpu['launches']} (want 3 K5 on the card, none on the CPU)")
    return {"phase": "train_reference", "model": "YOLOPoint-n", "input": [B, H, H],
            "dtype": "f32", "losses_card": gpu["losses"], "losses_cpu": cpu["losses"],
            "loss_max_rel": max(loss_rel.values()), "grad_norm_max_rel": grad_rel[worst_grad],
            "grad_norm_worst_tensor": worst_grad, "tensors": len(grad_rel),
            "launches_card": gpu["launches"]}


def train(seed: int, warmup: int = 2, steps: int = 6, device: str = "cuda"):
    """`TrainAgent` on the s640 training config: `warmup` untimed and `steps`
    timed micro-steps. A micro-step's time is the host clock around
    `TrainAgent.step` ending in a synchronize; its CUDA-event split is
    `augment` (the random draws and both views), `forward_backward` (two
    forwards, the losses, the backward) and `optimizer` (the finiteness
    check, accumulation or the update, the EMA). Returns the phase line and
    the warp launches of the timed steps."""
    from yolopoint_tpu_torch.ops import _build

    cfg = s640_train_config()
    tp = cfg["training_params"]
    B, (H, W) = tp["train_batch_size"], cfg["data"]["preprocessing"]["resize"]
    loader = SeededBatches(seed + 3, B, H, W, len(cfg["names"]), cfg["data"]["length"]["train"],
                           device)
    agent = step_agent(cfg, loader, seed=seed, device=device)
    if agent.accum != 2 or agent.compute_dtype != torch.bfloat16:
        raise AssertionError(f"train: accum {agent.accum}, dtype {agent.compute_dtype}")
    params = [p for _, p in agent.model.named_parameters()]
    ema0 = {n: t.clone() for n, t in agent.state.ema_params.items()}
    history = agent.train_steps(warmup)
    torch.cuda.synchronize()
    updates_before = agent.optimizer.count

    def flat():
        return torch.cat([p.detach().reshape(-1) for p in params])

    events, phases = [], ("augment", "forward_backward", "optimizer")

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1].append((name, ev))

    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    step_ms, moved = [], []
    batches = iter(loader)
    for _ in range(steps):
        before = flat()
        start = torch.cuda.Event(enable_timing=True)
        events.append([])
        t0 = time.perf_counter()
        start.record()
        aux = agent.step(next(batches), on_phase)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in aux.items()})
        moved.append(bool((flat() != before).any()))
        events[-1].insert(0, ("start", start))
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    split = {name: [] for name in phases}
    for evs in events:
        for (_, a), (name, b) in zip(evs, evs[1:]):
            split[name].append(a.elapsed_time(b))
    timed = history[warmup:]
    for h in history:
        bad = [k for k in LOSS_TERMS if not math.isfinite(h[k])]
        if bad or h["nonfinite_skip"] != 0.0:
            raise AssertionError(f"train: non-finite {bad} or skipped step: {h}")
    # micro-steps warmup+1 .. warmup+steps; an update lands on every accum-th
    expect_moved = [(warmup + i + 1) % agent.accum == 0 for i in range(steps)]
    if moved != expect_moved:
        raise AssertionError(f"train: parameters moved on {moved}, expected {expect_moved}")
    ema_moved = max(float((agent.state.ema_params[n] - ema0[n]).abs().max()) for n in ema0)
    if not ema_moved > 0:
        raise AssertionError("train: the EMA did not move")
    if agent.optimizer.count - updates_before != steps // agent.accum:
        raise AssertionError(f"train: {agent.optimizer.count - updates_before} updates in "
                             f"{steps} micro-steps at accum {agent.accum}")
    if launches.get("K4", 0) != 2 * steps or launches.get("K5", 0) != steps:
        raise AssertionError(f"train: warp launches {launches}, want {2 * steps} K4 and {steps} K5")
    med = statistics.median(step_ms)
    return {
        "phase": "train", "model": "YOLOPoint-s", "nc": len(cfg["names"]), "input": [H, W],
        "batch": B, "dtype": "bf16", "accum": agent.accum, "warmup_steps": warmup,
        "timed_steps": steps, "optimizer_updates_timed": agent.optimizer.count - updates_before,
        "ms_per_step_p50": med, "ms_per_step_all": step_ms, "images_per_s": B * 1e3 / med,
        "split_ms_p50": {k: statistics.median(v) for k, v in split.items()},
        "peak_memory_gb": peak / 1e9, "launches": launches,
        "ema_max_move": ema_moved, "params_moved": moved,
        "losses": {k: [h[k] for h in timed] for k in LOSS_TERMS},
    }, launches


@torch.inference_mode()
def serve_untiled(seed: int, B: int = 16, requests: int = 8, device: str = "cuda"):
    """`InferencePipeline` at NMS radius 3, where 640 is no multiple of the
    tile: the keypoints go through K6's map and the exact tile reduction.
    Returns the phase line and the launches of the timed requests."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.ops import _build

    cfg = dict(SERVE_CONFIG, nms=3)
    pipe = InferencePipeline(folded_yolopoint_s(seed, torch.bfloat16, device), cfg,
                             compute_dtype=torch.bfloat16, device=device)
    frames = torch.randint(0, 256, (B, 640, 640, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(seed + 5))
    for _ in range(2):
        pipe(frames)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    times = []
    for _ in range(requests):
        t0 = time.perf_counter()
        out = pipe(frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.launch_counts)
    if launches.get("K6", 0) != requests or launches.get("nms_tile_keys", 0):
        raise AssertionError(f"serve at radius 3: launches {launches}, want {requests} K6, no K1")
    n_kp = out["kp_valid"].sum(1).float()
    if not torch.isfinite(out["kp_scores"]).all() or not (n_kp > 0).all():
        raise AssertionError("serve at radius 3: no keypoints or non-finite scores")
    return {"phase": "serve_untiled", "model": "YOLOPoint-s", "input": [640, 640], "batch": B,
            "nms": 3, "dtype": "bf16", "latency_ms_p50": statistics.median(times),
            "latency_ms_all": times, "keypoints_per_image": float(n_kp.mean()),
            "launches": launches}, launches


VAL_WEIGHTS = dict(lambda_desc=0.1, lambda_obj=10.0, desc_loss_type="infonce", det_loss_type="ce",
                   num_samples_per_image=600, num_masked_non_matches_per_match=100)


def val_reference(seed: int, device: str = "cuda"):
    """The val step in f32 (TF32 off) on the card and on the CPU: YOLOPoint-n
    with seeded weights, nc=5 (multi-label box NMS over 5040 candidate slots:
    the tiled scan), 128x128, B=2, the s640 val augmentation, the same batch
    and random draws. Losses within 1e-4 relative; the decode of the same
    inputs (the card's base heatmap, descriptor map and decoded predictions,
    copied to the CPU) equal: keypoints bit-equal, descriptors within 1e-5,
    detections (multi-label, 30000 candidates: the tiled scan) matched within
    1e-4. The whole step's keypoint and detection counts are reported."""
    import copy

    from yolopoint_tpu_torch.losses import ObjectLossConfig
    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.models.detect import decode_levels
    from yolopoint_tpu_torch.ops import (_build, batched_box_nms, extract_keypoints,
                                         sample_descriptors)
    from yolopoint_tpu_torch.training import (LossWeights, draw_step, make_val_step,
                                              rescale_yolo_gains)

    cfg = s640_train_config()
    nc, B, H = len(cfg["names"]), 2, 128
    sp, yolo = cfg["model"]["superpoint"], cfg["model"]["yolo"]
    weights = LossWeights(**VAL_WEIGHTS)
    obj = rescale_yolo_gains(ObjectLossConfig(**{k: yolo[k] for k in ("box", "obj", "cls",
                                                                       "anchor_t")}), nc, H)
    model_cpu = build_model("YOLOPoint", "n", nc=nc, device="cpu")
    random_weights(model_cpu, seed)
    batch_cpu = SeededBatches(seed + 1, B, H, H, nc, B, "cpu", distinct=1).batches[0]
    draws_cpu = draw_step(torch.Generator().manual_seed(seed + 2), (B, H, H, 3),
                          cfg["data"]["val_augmentation"], weights)
    kpt = (sp["detection_threshold"], sp["nms"], sp["top_k"])
    box = dict(conf_thres=yolo["conf_thresh"], iou_thres=yolo["iou_thresh"], max_det=300,
               max_nms=30000, multi_label=True)
    res, models = {}, {}
    for dev in ("cpu", device):
        models[dev] = copy.deepcopy(model_cpu).to(dev)
        step = make_val_step(models[dev], cfg["data"]["val_augmentation"], obj, weights, nc,
                             kpt_conf=kpt[0], kpt_nms=kpt[1], kpt_topk=kpt[2])
        _build.launch_counts.clear()
        res[dev] = step(None, _to(batch_cpu, dev), _to(draws_cpu, dev))
        if dev != "cpu":
            torch.cuda.synchronize()
        res[dev]["launches"] = dict(_build.launch_counts)
    cpu, gpu = res["cpu"], _to(res[device], "cpu")
    loss_rel = {k: abs(float(gpu["losses"][k]) - float(v)) / max(abs(float(v)), 1e-12)
                for k, v in cpu["losses"].items()}
    if not max(loss_rel.values()) <= 1e-4:
        raise AssertionError(f"val_reference: losses card vs CPU {loss_rel} above 1e-4")
    # the whole step's decode, for information: its inputs differ by the
    # forward's f32 rounding, which reorders near-tied boxes (see check_reference)
    end_to_end = {v: {"detections_card": gpu[v]["det"]["valid"].sum(1).tolist(),
                      "detections_cpu": cpu[v]["det"]["valid"].sum(1).tolist(),
                      "keypoints_card": gpu[v]["valid"].sum(1).tolist(),
                      "keypoints_cpu": cpu[v]["valid"].sum(1).tolist()}
                  for v in ("base", "warped")}

    # the decode of the same inputs: the card's base heatmap and predictions
    heat = res[device]["base"]["heatmap"]
    with torch.no_grad():
        x = models[device](res[device]["image"].permute(0, 3, 1, 2).contiguous())
        pred = decode_levels(x["objects"], models[device].Detect.anchors_per_stride(),
                             models[device].Detect.strides)
        desc = x["desc"].permute(0, 2, 3, 1).contiguous()
    kp_g, kp_c = extract_keypoints(heat, *kpt), extract_keypoints(heat.cpu(), *kpt)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(kp_g, kp_c)) or not kp_c[2].any():
        raise AssertionError("val_reference: keypoints of the same heatmap differ or are none")
    desc_err = float((sample_descriptors(desc, kp_g[0]).cpu()
                      - sample_descriptors(desc.cpu(), kp_c[0])).abs().max())
    if not desc_err <= 1e-5:
        raise AssertionError(f"val_reference: descriptors of the same map differ by {desc_err}")
    same = same_detections(batched_box_nms(pred, **box), batched_box_nms(pred.cpu(), **box),
                           "val_reference, same predictions", 1e-4)
    if int(cpu["base"]["det"]["n_candidates"].min()) <= 0 or pred.shape[1] * nc <= 2048:
        raise AssertionError("val_reference: the tiled scan did not run")
    launches = res[device]["launches"]
    warps = launches.get("K4", 0) + launches.get("K5", 0)  # 128 px images count as K5
    if warps <= 0 or any(launches.get(n, 0) <= 0 for n in ("nms_tile_keys", "greedy_nms_keep",
                                                            "sample_descriptors")):
        raise AssertionError(f"val_reference: launches {launches}, want K1-K3 and the warp")
    if res["cpu"]["launches"]:
        raise AssertionError(f"val_reference: the CPU launched {res['cpu']['launches']}")
    return {"phase": "val_reference", "model": "YOLOPoint-n", "nc": nc, "input": [B, H, H],
            "dtype": "f32", "loss_max_rel": max(loss_rel.values()),
            "losses_card": {k: float(v) for k, v in gpu["losses"].items()},
            "candidates": cpu["base"]["det"]["n_candidates"].tolist(),
            "decode_end_to_end": end_to_end, "detections_same_inputs": same,
            "keypoints_same_inputs": int(kp_c[2].sum()), "descriptor_max_abs": desc_err,
            "launches_card": launches}


def val(seed: int, warmup: int = 1, batches: int = 4, device: str = "cuda"):
    """`TrainAgent.validate` on the s640 config (YOLOPoint-S, nc=5, 640x640,
    B=8 = `val_batch_size`, the val augmentation, seeded weights): `warmup`
    untimed and `batches` timed batches (32 images, all in the extended
    metrics). A batch's time is the host clock from the previous batch's
    metrics to its own; its CUDA-event split: views (the draws and both
    views), forward (two forwards), losses, keypoints, descriptors and
    box_nms (summed over both views), host (the copy to the host and the
    numpy metrics, RANSAC included), and that host part split a batch into
    matching, the compiled RANSAC and the rest (`host_split_probes`).
    Returns the phase line and the launches of the timed batches."""
    from yolopoint_tpu_torch.ops import _build

    cfg = s640_train_config()
    B, (H, W) = cfg["training_params"]["val_batch_size"], cfg["data"]["preprocessing"]["resize"]
    nc = len(cfg["names"])
    loader = SeededBatches(seed + 4, B, H, W, nc, B * (warmup + batches), device,
                           distinct=warmup + batches)
    agent = step_agent(cfg, loader, loader.batches[:warmup], seed=seed, device=device)
    if agent.val_aug_config != cfg["data"]["val_augmentation"] or \
            agent.extended_val_n != B * batches:
        raise AssertionError("val: the agent did not take the val config")
    per_batch = []
    val_step = agent.val_step

    def recording(params, batch, draws, on_phase=None):
        out = val_step(params, batch, draws, on_phase)
        per_batch.append({v: (out[v]["det"]["n_candidates"], out[v]["det"]["valid"].sum(1))
                          for v in ("base", "warped")})
        return out

    agent.val_step = recording
    agent.validate()
    torch.cuda.synchronize()
    per_batch.clear()

    marks = []  # (phase name, CUDA event, host time)

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    on_phase("start")
    agent.val_loader = loader.batches[warmup:]
    with host_split_probes() as probe:
        scalars = agent.validate(on_phase=on_phase)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    batch_ms, split, acc, t_prev = [], [], {}, marks[0][2]
    for (_, a, _), (name, b, tb) in zip(marks, marks[1:]):
        acc[name] = acc.get(name, 0.0) + a.elapsed_time(b)
        if name == "host":  # the end of a batch
            batch_ms.append((tb - t_prev) * 1e3)
            split.append(acc)
            acc, t_prev = {}, tb
    bad = [k for k, v in scalars.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"val: non-finite scalars {bad}")
    cand = torch.stack([c for pb in per_batch for c, _ in pb.values()]).float()
    dets = torch.stack([d for pb in per_batch for _, d in pb.values()]).float()
    if len(batch_ms) != batches or not bool((cand > 2048).all()):
        raise AssertionError(f"val: {len(batch_ms)} batches, candidates {cand.tolist()}")
    for name in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors", "K4", "K5"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"val: kernel {name} was not launched on the val path")
    if probe["compiled_calls"] <= 0:
        raise AssertionError("val: no homography was estimated")
    host = {k: probe[k] / batches for k in ("matching", "ransac")}
    host["rest"] = statistics.mean(s["host"] for s in split) - sum(host.values())
    return {
        "phase": "val", "model": "YOLOPoint-s", "nc": nc, "input": [H, W], "batch": B,
        "dtype": "bf16", "warmup_batches": warmup, "timed_batches": batches,
        "ms_per_batch_p50": statistics.median(batch_ms), "ms_per_batch_all": batch_ms,
        "images_per_s": B * 1e3 / statistics.median(batch_ms),
        "split_ms_p50": {k: statistics.median(s.get(k, 0.0) for s in split) for k in split[0]},
        "candidates_per_image": float(cand.mean()), "candidates_min": float(cand.min()),
        "detections_per_image": float(dets.mean()), "peak_memory_gb": peak / 1e9,
        "host_split_ms_per_batch_mean": host, "ransac_calls": probe["compiled_calls"],
        "ransac": "compiled (cv2.findHomography's)", "scalars": scalars, "launches": launches,
    }, launches


# ---------------------------------------------------------------- the training entry

FIT_OVERRIDES = {  # configs/synthetic_s640.yaml, cut in depth only, on the device warp path
    "data": {"length": {"train": 128, "val": 16}, "augmentation": {"host_warp": False}},
    "training_params": {"epochs": 2, "val_interval": 1, "save_interval": 1},
}
FIT_KERNELS = ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors", "K4", "K5")


@contextlib.contextmanager
def fit_probes():
    """Class-level timers around the training entry's layers while the CLI
    runs: every `SyntheticShapes._render` (host seconds; on the main thread,
    or in the val loader's worker threads, which share the interpreter lock),
    every micro-step
    (`TrainAgent.step`, host clock to a synchronize; its losses kept), every
    val batch (host clock between the val step's "host" marks), every
    checkpoint write (`CheckpointManager.save`) and the start of every epoch
    (the epoch's rows drawn from the `DeviceDataLoader`). Yields the lists
    they fill."""
    from yolopoint_tpu_torch.data.device_data import DeviceDataLoader
    from yolopoint_tpu_torch.data.synthetic import SyntheticShapes
    from yolopoint_tpu_torch.training import TrainAgent
    from yolopoint_tpu_torch.training.checkpoint import CheckpointManager

    rec = {"render_s": [], "render_pool_s": [], "step_ms": [], "step_losses": [],
           "val_batch_ms": [], "val_s": [], "save_s": [], "epoch_start": []}
    real = {(SyntheticShapes, "_render"): SyntheticShapes._render,
            (TrainAgent, "step"): TrainAgent.step, (TrainAgent, "validate"): TrainAgent.validate,
            (CheckpointManager, "save"): CheckpointManager.save,
            (DeviceDataLoader, "epoch_rows"): DeviceDataLoader.epoch_rows}

    def render(self, idx):
        cached = idx in self._cache
        t0 = time.perf_counter()
        out = real[(SyntheticShapes, "_render")](self, idx)
        if not cached:  # the loader's worker threads render the val set concurrently
            serial = threading.current_thread() is threading.main_thread()
            rec["render_s" if serial else "render_pool_s"].append(time.perf_counter() - t0)
        return out

    def step(self, batch, on_phase=None):
        t0 = time.perf_counter()
        aux = real[(TrainAgent, "step")](self, batch, on_phase)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["step_losses"].append({k: float(aux[k]) for k in LOSS_TERMS})
        return aux

    def validate(self, epoch=0, on_phase=None):
        marks = [time.perf_counter()]

        def mark(name):
            if name == "host":
                marks.append(time.perf_counter())

        out = real[(TrainAgent, "validate")](self, epoch, mark)
        rec["val_batch_ms"] += [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        rec["val_s"].append(time.perf_counter() - marks[0])
        return out

    def save(self, *args, **kwargs):
        t0 = time.perf_counter()
        real[(CheckpointManager, "save")](self, *args, **kwargs)
        rec["save_s"].append(time.perf_counter() - t0)

    def epoch_rows(self):
        rec["epoch_start"].append(time.perf_counter())
        return real[(DeviceDataLoader, "epoch_rows")](self)

    wrappers = {"_render": render, "step": step, "validate": validate, "save": save,
                "epoch_rows": epoch_rows}
    for (cls, name) in real:
        setattr(cls, name, wrappers[name])
    try:
        yield rec
    finally:
        for (cls, name), fn in real.items():
            setattr(cls, name, fn)


def state_tensors(agent) -> dict:
    """Every tensor of an agent's train state, by name (on its device)."""
    opt = agent.optimizer
    out = {f"model.{k}": v for k, v in agent.model.state_dict().items()}
    out.update({f"acc.{i}": a for i, a in enumerate(opt.acc)})
    for i, st in enumerate(opt.adamw.state.values()):
        out.update({f"adamw.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    out.update({f"ema.{k}": v for k, v in (agent.state.ema_params or {}).items()})
    return out


def fit(seed: int, train_ms: float, device: str = "cuda"):
    """The training entry on the card: `configs/synthetic_s640.yaml` written
    by the port's `save_config` to a temporary directory with only
    `FIT_OVERRIDES` changed (YOLOPoint-S, nc=5, 640x640, B=32, bf16, accum 2,
    EMA; 128 train and 16 val images, 2 epochs, validation and a checkpoint
    every epoch), then
      1. `training.cli.main` on it: renders 144 images on the host (4 shapes
         each), puts the training set on the card, 4 micro-steps and 2 val
         batches an epoch;
      2. `--resume` with 3 epochs: the rebuilt agent's state equal to the
         first run's on the card, tensor by tensor, training from epoch 2;
      3. an agent with `pretrained:` a seeded nc=80 YOLOPoint-S file in the
         reference schema and `shrink_perturb` {lam 0.5, sigma 0.01}: only
         Detect tensors mismatch, and the weights moved as configured.
    Checks finite losses and scalars, the checkpoint files and `done.json`
    against the schedule, and K1-K5 launched on this path (both runs).
    Returns the phase line and the path's launches."""
    from yolopoint_tpu_torch.data.device_data import DeviceDataLoader
    from yolopoint_tpu_torch.models.convert import load_weights
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.training import cli
    from yolopoint_tpu_torch.utils.config import dict_update, save_config

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = dict_update(s640_train_config(), FIT_OVERRIDES)
        save_config(cfg, tmp / "fit.yaml")
        argv = ["--config", str(tmp / "fit.yaml"), "--exper_name", "fit", "--output_dir",
                str(tmp / "logs"), "--data_root", str(tmp / "data"), "--seed", str(seed),
                "--device", device]
        run = tmp / "logs" / "fit"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        with fit_probes() as rec:
            t0 = time.perf_counter()
            agent = cli.main(argv)
            torch.cuda.synchronize()
            wall_run1 = time.perf_counter() - t0
            files_run1 = sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())
            done1 = json.loads((run / "done.json").read_text())
            epoch_s = [b - a for a, b in zip(rec["epoch_start"], rec["epoch_start"][1:])]
            epoch_s.append(t0 + wall_run1 - rec["epoch_start"][-1])
            runs = {"run1": {k: list(v) for k, v in rec.items() if k != "epoch_start"}}
            for v in rec.values():
                v.clear()
            dict_update(cfg, {"training_params": {"epochs": 3}})
            save_config(cfg, tmp / "fit.yaml")
            resumed = cli.build_agent(argv + ["--resume"])
            saved, now = state_tensors(agent), state_tensors(resumed)
            differ = [k for k in saved if not torch.equal(saved[k], now[k])]
            if set(saved) != set(now) or differ or resumed.start_epoch != 2 \
                    or resumed.global_step != agent.global_step \
                    or resumed.best_fitness != agent.best_fitness:
                raise AssertionError(
                    f"fit: resume differs ({len(differ)} tensors, e.g. {differ[:3]}; start "
                    f"epoch {resumed.start_epoch}, global step {resumed.global_step} vs "
                    f"{agent.global_step}, best {resumed.best_fitness} vs {agent.best_fitness})")
            resumed.train()
            torch.cuda.synchronize()
            runs["resume"] = {k: list(v) for k, v in rec.items() if k != "epoch_start"}
        launches = dict(_build.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        done2 = json.loads((run / "done.json").read_text())
        files = sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())
        records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]

        weights = tmp / "yolopoint_s_nc80.pt"
        save_reference_weights(weights, seed, version="s", names=[f"c{i}" for i in range(80)])
        dict_update(cfg, {"shrink_perturb": {"lam": 0.5, "sigma": 0.01}})
        save_config(cfg, tmp / "fit.yaml")
        warm = cli.build_agent(argv[:3] + ["warm"] + argv[4:] + ["--pretrained", str(weights)])
        report = warm.pretrained_report
        source = load_weights(weights)["state_dict"]
        name = "Conv1.conv.weight"
        noise = (warm.model.state_dict()[name].cpu() - 0.5 * source[name]) / 0.01
        ema_start = float((warm.state.ema_params[name] - warm.model.state_dict()[name]).abs().max())

    # every micro-step's losses, from the probe: with 4 micro-steps an epoch and
    # `steps_per_dispatch` 8 no dispatch is full, and the loop, as the JAX one,
    # logs no `training/` record for the leftover micro-steps it runs
    step_losses = runs["run1"]["step_losses"] + runs["resume"]["step_losses"]
    train_loss = [h["loss"] for h in step_losses]
    n_train_records = sum("training/loss" in r for r in records)
    val = [{k[len("validation/"):]: v for k, v in r.items() if k.startswith("validation/")}
           for r in records if "validation/fitness" in r]
    bad = [k for h in step_losses + val for k, x in h.items() if not math.isfinite(x)]
    if len(step_losses) != 12 or bad or len(val) != 3:
        raise AssertionError(f"fit: {len(step_losses)} micro-steps, {len(val)} validations, "
                             f"non-finite {bad}")
    if not isinstance(agent.train_loader, DeviceDataLoader):
        raise AssertionError("fit: the training set did not go to the card")
    want_files = {"config.yml", "metrics.jsonl", "done.json", "best.pt", "best_meta.json",
                  "meta_0.json", "meta_1.json", "ckpts/0.pt", "ckpts/1.pt"}
    if not want_files <= set(files_run1) or \
            (done1["last_epoch"], done1["global_step"], done1["stopped_early"]) != (1, 8, False):
        raise AssertionError(f"fit: run 1 wrote {files_run1}, done {done1}")
    if not want_files | {"meta_2.json", "ckpts/2.pt"} <= set(files) or \
            (done2["last_epoch"], done2["global_step"]) != (2, 12):
        raise AssertionError(f"fit: the resumed run wrote {files}, done {done2}")
    mismatch = report["shape_mismatch"]
    if not mismatch or any(not n.startswith("Detect.") for n in mismatch) or \
            len(report["loaded"]) < 100:
        raise AssertionError(f"fit: warm start loaded {len(report['loaded'])}, mismatched "
                             f"{mismatch}")
    if not (abs(float(noise.mean())) < 0.1 and 0.8 < float(noise.std()) < 1.2) or ema_start:
        raise AssertionError(f"fit: shrink-perturb noise mean {float(noise.mean())} std "
                             f"{float(noise.std())}, EMA off the weights by {ema_start}")
    for k in FIT_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"fit: kernel {k} was not launched on the training entry")
    r1 = runs["run1"]
    renders = r1["render_s"] + runs["resume"]["render_s"]
    pool_renders = r1["render_pool_s"] + runs["resume"]["render_pool_s"]
    steps = r1["step_ms"] + runs["resume"]["step_ms"]
    return {
        "phase": "fit", "model": "YOLOPoint-s", "nc": len(cfg["names"]),
        "input": cfg["data"]["preprocessing"]["resize"],
        "batch": cfg["training_params"]["train_batch_size"], "dtype": "bf16",
        "accum": agent.accum, "overrides": FIT_OVERRIDES,
        "render_images": len(renders), "render_s_per_image": statistics.mean(renders),
        "render_images_val_pool": len(pool_renders),
        "render_s_per_image_val_pool": statistics.mean(pool_renders),
        "epoch_s": epoch_s, "wall_run1_s": wall_run1,
        "ms_per_step_p50": statistics.median(steps), "ms_per_step_all": steps,
        "train_phase_ms_per_step_p50": train_ms,
        "ms_per_val_batch_p50": statistics.median(r1["val_batch_ms"]),
        "val_batch_ms_all": r1["val_batch_ms"] + runs["resume"]["val_batch_ms"],
        "val_s_per_epoch": r1["val_s"], "checkpoint_save_s": r1["save_s"] + runs["resume"]["save_s"],
        "peak_memory_gb": peak / 1e9, "device_dataset_gb": agent.train_loader.nbytes / 1e9,
        "val_scalars": val, "train_loss": train_loss, "training_records": n_train_records,
        "files": files,
        "done": [done1, done2], "resume": {"start_epoch": 2, "tensors_equal": len(saved)},
        "warm_start": {"loaded": len(report["loaded"]), "shape_mismatch": mismatch,
                       "noise_mean": float(noise.mean()), "noise_std": float(noise.std())},
        "launches": launches,
    }, launches


# ---------------------------------------------------------------- serving consumers

# configs/inference.yaml, the demo and ROS operating point, at the serving
# detection threshold 0.015 in place of its 0.12: random weights put the
# heatmap near 1/65, and no keypoint would pass 0.12
INFERENCE_CONFIG = {
    "detection_threshold": 0.015, "nms": 8, "top_k": 600, "border_remove": 4,
    "conf_thresh": 0.25, "iou_thresh": 0.45, "max_det": 300, "filter_pts_in_boxes": True,
}
INFERENCE_IMG_SIZE = 640


def grey_images(seed: int, n: int, H: int, W: int) -> list:
    """`n` seeded grey uint8 `(H, W, 3)` numpy images (one grey plane
    repeated, as `SyntheticShapes.get` returns its renders): flat rectangles
    of random levels on a flat background, with mild noise."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        img = torch.full((H, W), float(torch.randint(30, 220, (1,), generator=gen)))
        for _ in range(24):
            y0 = int(torch.randint(0, H - 8, (1,), generator=gen))
            x0 = int(torch.randint(0, W - 8, (1,), generator=gen))
            h = int(torch.randint(8, max(H // 3, 9), (1,), generator=gen))
            w = int(torch.randint(8, max(W // 3, 9), (1,), generator=gen))
            img[y0:y0 + h, x0:x0 + w] = float(torch.randint(0, 256, (1,), generator=gen))
        img = (img + torch.randn(H, W, generator=gen) * 4.0).round().clamp(0, 255)
        out.append(img.to(torch.uint8)[..., None].expand(H, W, 3).numpy().copy())
    return out


@torch.inference_mode()
def serve_frame(seed: int, requests: int = 8, device: str = "cuda"):
    """`InferencePipeline.process_frame(frame, img_size=640)` on 720x1280
    uint8 frames at the demo operating point (`INFERENCE_CONFIG`;
    YOLOPoint-S, bf16, BN folded): the resize (`ops.resize`, INTER_AREA at
    ratio 0.5) and the crop on the host, then the pipeline on the card.
    Checks the outputs' shapes, that they are finite and mapped back into
    the frame, and one K1, K2 and K3 launch per frame. Returns the phase
    line and the launches of the timed frames."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.ops import _build

    pipe = InferencePipeline(folded_yolopoint_s(seed, torch.bfloat16, device), INFERENCE_CONFIG,
                             compute_dtype=torch.bfloat16, device=device)
    frame = grey_images(seed + 7, 1, 720, 1280)[0]
    frame[..., 2] = frame[..., 0] // 2  # a colour frame
    for _ in range(2):
        pipe.process_frame(frame, INFERENCE_IMG_SIZE)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    times = []
    for _ in range(requests):
        t0 = time.perf_counter()
        out = pipe.process_frame(frame, INFERENCE_IMG_SIZE)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.launch_counts)
    kp = out["keypoints"][out["kp_valid"]]
    if out["keypoints"].shape != (INFERENCE_CONFIG["top_k"], 2) or out["boxes"].shape != (300, 4):
        raise AssertionError(f"process_frame: shapes {out['keypoints'].shape} {out['boxes'].shape}")
    if not all(math.isfinite(float(v.sum())) for v in out.values() if v.dtype.kind == "f"):
        raise AssertionError("process_frame: non-finite outputs")
    if len(kp) == 0 or kp.min() < 0 or (kp[:, 0] > 1279).any() or (kp[:, 1] > 719).any():
        raise AssertionError(f"process_frame: {len(kp)} keypoints, or some off the 720x1280 frame")
    for name in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors"):
        if launches.get(name, 0) != requests:
            raise AssertionError(f"process_frame: launches {launches}, want {requests} of {name}")
    return {"phase": "serve_frame", "model": "YOLOPoint-s", "frame": [720, 1280],
            "img_size": INFERENCE_IMG_SIZE, "dtype": "bf16", "config": INFERENCE_CONFIG,
            "ms_p50": statistics.median(times), "ms_all": times, "keypoints": int(len(kp)),
            "launches": launches}, launches


# ---------------------------------------------------------------- the other families

KITTI_FRAME = (375, 1242)  # a KITTI frame, H x W
SERVE_THRESHOLD = 0.015  # random weights put the heatmap near 1/65, under 0.12
PIPELINE_KEYS = ("detection_threshold", "nms", "top_k", "border_remove", "conf_thresh",
                 "iou_thresh", "max_det", "filter_pts_in_boxes")


def kitti_inference_config() -> dict:
    """`configs/kitti_inference.yaml`, read by the port's config reader."""
    from yolopoint_tpu_torch.utils.config import load_config

    return load_config(REPO / "configs" / "kitti_inference.yaml")


def pipeline_settings(cfg: dict) -> dict:
    """An inference config's `model.superpoint` and `model.yolo` keys and
    its `inference` section merged into one flat dict of the pipeline's
    keys, as the JAX package's ROS node takes its settings."""
    merged = {**cfg["model"].get("superpoint", {}), **cfg["model"].get("yolo", {}),
              **cfg.get("inference", {})}
    return {k: merged[k] for k in PIPELINE_KEYS if k in merged}


def panning_frames(seed: int, n: int, H: int, W: int, step: int = 3) -> list:
    """`n` uint8 colour frames of `H x W`: windows of one seeded grey scene
    moving `step` pixels right a frame (a camera pan), so that points
    persist from frame to frame."""
    scene = grey_images(seed, 1, H, W + step * n)[0]
    scene[..., 2] = scene[..., 0] // 2
    return [np.ascontiguousarray(scene[:, step * i:step * i + W]) for i in range(n)]


def decode_both(pipe, raw) -> tuple[dict, dict]:
    """The decode of the same raw outputs on the card (kernels) and on the
    CPU (plain versions), as numpy, the pipeline's `decode` stage by stage
    from one heatmap: the card's softmax goes to both sides (random weights
    put the heatmap near 1/65, by the 0.015 threshold, where an ulp of
    softmax moves keypoints). Also checks that the pipeline's own `decode`
    on the card gives the card's side exactly."""
    from yolopoint_tpu_torch.frontend.pipeline import _points_in_boxes
    from yolopoint_tpu_torch.ops import (cells_to_heatmap, extract_keypoints, fused_detect_nms,
                                         sample_descriptors)

    heat = cells_to_heatmap(raw["semi"].float().permute(0, 2, 3, 1), dtype=pipe.heatmap_dtype)
    desc = raw["desc"].permute(0, 2, 3, 1).contiguous()
    sides = []
    for dev in (heat.device, torch.device("cpu")):
        pts, scores, valid = extract_keypoints(heat.to(dev), pipe.conf_thresh, pipe.nms_radius,
                                               pipe.top_k, pipe.border)
        r = {"keypoints": pts, "kp_scores": scores, "kp_valid": valid}
        if "objects" in raw:
            det = fused_detect_nms([o.to(dev) for o in raw["objects"]], pipe._anchors_ps,
                                   pipe._strides, conf_thres=pipe.box_conf,
                                   iou_thres=pipe.box_iou, max_det=pipe.max_det,
                                   max_nms=pipe.max_nms)
            r.update(boxes=det["boxes"], box_scores=det["scores"], box_classes=det["classes"],
                     box_valid=det["valid"], box_n_candidates=det["n_candidates"])
            if pipe.filter_pts_in_boxes:
                r["kp_valid"] = valid & ~_points_in_boxes(pts, det["boxes"], det["valid"])
        r["descriptors"] = sample_descriptors(desc.to(dev), pts)
        sides.append({k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
                      for k, v in r.items()})
    own = pipe.decode(raw)
    if set(own) != set(sides[0]) or not all(
            np.array_equal(v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy(),
                           sides[0][k]) for k, v in own.items()):
        raise AssertionError("the pipeline's decode differs from its stages on the card")
    return sides[0], sides[1]


def compare_decodes(g: dict, c: dict, what: str) -> dict:
    """Card against CPU decodes of the same raw outputs: the same keys,
    keypoints, scores and validity equal, descriptors within 1e-5, and where
    there are boxes the same count with sorted coordinates within 1e-3 (the
    serving gate's boxes; `fused_detect_nms` on the same raw levels)."""
    if set(g) != set(c):
        raise AssertionError(f"{what}: keys {sorted(g)} vs {sorted(c)}")
    for k in ("keypoints", "kp_scores", "kp_valid"):
        if not np.array_equal(g[k], c[k]):
            raise AssertionError(f"{what}: {k} differ between the card and the CPU")
    desc_err = float(np.abs(g["descriptors"] - c["descriptors"]).max())
    if not desc_err <= 1e-5:
        raise AssertionError(f"{what}: descriptors differ by {desc_err} > 1e-5")
    out = {"keypoints": int(c["kp_valid"].sum()), "descriptor_max_abs": desc_err}
    if "boxes" in c:
        nb = int(c["box_valid"].sum())
        if int(g["box_valid"].sum()) != nb:
            raise AssertionError(f"{what}: boxes {int(g['box_valid'].sum())} vs {nb}")
        bg, bc = np.sort(g["boxes"][g["box_valid"]], 0), np.sort(c["boxes"][c["box_valid"]], 0)
        err = float(np.abs(bg - bc).max()) if nb else 0.0
        if not err <= 1e-3:
            raise AssertionError(f"{what}: box coordinates differ by {err} > 1e-3")
        out.update(boxes=nb, box_max_abs=err)
    return out


def same_matches(prev, cur, nn_thresh: float, desc_err: float) -> dict:
    """The tracker's frame-to-frame matches (`match_descriptors`) of the
    card's decodes (`prev[0]` -> `cur[0]`, `(D, N)` descriptors) against
    the CPU's (`prev[1]` -> `cur[1]`). Each decision is a comparison of
    cosines (nearest against second nearest, both ways, and against the
    threshold's cosine `1 - t^2 / 2`); descriptors within `desc_err` of each
    other move a cosine by at most `2 sqrt(D) desc_err`. A match found on one
    side only must hinge on a decision whose margin on the card's cosines is
    within that bound (plus f32 rounding): such decisions are counted as
    `borderline`; any other difference raises. (Random weights give smooth
    descriptor maps: neighbouring points' descriptors nearly coincide, and
    f32 distances below ~3.5e-4 round to 0, so exact ties occur.)"""
    from yolopoint_tpu_torch.frontend.tracker import match_descriptors

    sides = [match_descriptors(a, b, nn_thresh) for a, b in zip(prev, cur)]
    pairs = [set(zip(m[0].astype(int).tolist(), m[1].astype(int).tolist())) for m in sides]
    cos = prev[0].astype(np.float64).T @ cur[0].astype(np.float64)
    bound = 2.0 * math.sqrt(prev[0].shape[0]) * desc_err + 1e-6
    c_thresh = 1.0 - nn_thresh**2 / 2.0

    def gap(v):
        top = np.sort(v)[-2:]
        return top[1] - top[0] if len(v) > 1 else np.inf

    borderline = 0
    for i, j in pairs[0] ^ pairs[1]:
        margin = min(gap(cos[i]), gap(cos[:, j]), abs(cos[i].max() - c_thresh),
                     abs(cos[:, j].max() - c_thresh))
        if margin > bound:
            raise AssertionError(f"serve_kitti: match ({i}, {j}) differs between the card and "
                                 f"the CPU at a margin {margin} > {bound}")
        borderline += 1
    return {"matches": len(pairs[0]), "borderline": borderline, "bound": bound}


@torch.inference_mode()
def serve_kitti(seed: int, frames: int = 12, device: str = "cuda"):
    """The KITTI demo and ROS operating point, `configs/kitti_inference.yaml`:
    YOLOPointv52-S (nc=7, bf16, BN folded, seeded random weights),
    `process_frame(frame, img_size=960)` on `frames` uint8 375x1242 frames
    of a panning scene (a (1, 288, 960) request each), the settings of its
    `superpoint`, `yolo` and `inference` keys merged as the JAX ROS node
    takes them with only the keypoint threshold lowered to 0.015, and a
    `PointTracker(max_length=4, nn_thresh=0.7)` updated every frame with
    `get_tracks(min_length=2)` read each frame. A frame's time is the host
    clock around `process_frame` (ending in the copy to the host) and the
    tracker. Checks one K1, K2 and K3 launch a frame, the outputs' shapes and
    that keypoints land in the frame; then, per frame, the decode of the
    same raw outputs on the card and on the CPU (`compare_decodes`), the
    boxes of the card's decoded predictions at the gate 0.001 on both
    (`same_detections`), the tracker's matches of the card's and the CPU's
    decodes (`same_matches`: equal but for decisions within the margin the
    descriptors' difference allows), and two trackers fed those decodes:
    where no decision was borderline, the same tracks with scores within
    1e-5."""
    from yolopoint_tpu_torch.frontend import InferencePipeline, PointTracker, preprocess_frame
    from yolopoint_tpu_torch.models.detect import decode_levels
    from yolopoint_tpu_torch.ops import _build, batched_box_nms

    cfg = kitti_inference_config()
    m, inf, sp = cfg["model"], cfg["inference"], cfg["model"]["superpoint"]
    nc, img_size = len(cfg["names"]), inf["img_size"]
    dtype = torch.bfloat16 if str(m["dtype"]).lower() in ("bf16", "bfloat16") else torch.float32
    settings = pipeline_settings(cfg)
    lowered = {"detection_threshold": [settings["detection_threshold"], SERVE_THRESHOLD]}
    settings["detection_threshold"] = SERVE_THRESHOLD
    print(f"serve_kitti: detection_threshold lowered from {lowered['detection_threshold'][0]} "
          f"to {SERVE_THRESHOLD} (random weights)", file=sys.stderr, flush=True)
    pipe = InferencePipeline(folded_model(m["name"], m["version"], seed, dtype, device, nc),
                             settings, compute_dtype=dtype, device=device)
    seq = panning_frames(seed + 12, frames, *KITTI_FRAME)

    def track(tracker, out):
        v = out["kp_valid"]
        tracker.update(np.vstack([out["keypoints"][v].T, out["kp_scores"][v]]),
                       out["descriptors"][v].T)
        return tracker.get_tracks(min_length=sp["min_length"])

    for f in seq[:2]:
        pipe.process_frame(f, img_size)
    torch.cuda.synchronize()
    tracker = PointTracker(inf["tracker_max_length"], inf["nn_thresh"])
    _build.launch_counts.clear()
    times, alive, outs = [], [], []
    for f in seq:
        t0 = time.perf_counter()
        out = pipe.process_frame(f, img_size)
        tracks = track(tracker, out)
        times.append((time.perf_counter() - t0) * 1e3)
        alive.append(len(tracks))
        outs.append(out)
    launches = dict(_build.launch_counts)
    for name in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors"):
        if launches.get(name, 0) != frames:
            raise AssertionError(f"serve_kitti: launches {launches}, want {frames} of {name}")
    H, W = KITTI_FRAME
    for out in outs:
        kp = out["keypoints"][out["kp_valid"]]
        if out["keypoints"].shape != (settings["top_k"], 2) \
                or out["boxes"].shape != (settings["max_det"], 4):
            raise AssertionError(f"serve_kitti: shapes {out['keypoints'].shape} "
                                 f"{out['boxes'].shape}")
        if len(kp) == 0 or kp.min() < 0 or (kp[:, 0] > W - 1).any() or (kp[:, 1] > H - 1).any():
            raise AssertionError(f"serve_kitti: {len(kp)} keypoints, or some off the frame")
    if max(alive) == 0:
        raise AssertionError("serve_kitti: the tracker kept no track of length 2")

    # card against CPU, on the same raw outputs
    trackers = [PointTracker(inf["tracker_max_length"], inf["nn_thresh"]) for _ in range(2)]
    checks, low, matches = [], [], []
    prev = None
    for f in seq:
        img, (top, left), ratio = preprocess_frame(f, img_size)
        raw = pipe.forward(torch.from_numpy(img[None]).to(device))
        g, c = decode_both(pipe, raw)
        checks.append(compare_decodes(g, c, "serve_kitti"))
        pred = decode_levels(raw["objects"], pipe._anchors_ps, pipe._strides)
        low_kw = dict(conf_thres=0.001, iou_thres=settings["iou_thresh"],
                      max_det=settings["max_det"], max_nms=pipe.max_nms)
        low.append(same_detections(batched_box_nms(pred, **low_kw),
                                   batched_box_nms(pred.cpu(), **low_kw),
                                   "serve_kitti conf 0.001", 1e-4)["boxes_compared"])
        desc = [o["descriptors"][0][o["kp_valid"][0]].T for o in (g, c)]
        if prev is not None:
            matches.append(same_matches(prev, desc, inf["nn_thresh"],
                                        checks[-1]["descriptor_max_abs"]))
        prev = desc
        for tr, o in zip(trackers, (g, c)):
            o = {k: v[0] for k, v in o.items()}
            o["keypoints"] = (o["keypoints"] + np.array([left, top])) / ratio
            track(tr, o)
    tg, tc = trackers[0].tracks, trackers[1].tracks
    tracks_equal = tg.shape == tc.shape and np.array_equal(np.delete(tg, 1, axis=1),
                                                           np.delete(tc, 1, axis=1))
    borderline = sum(mt["borderline"] for mt in matches)
    if not borderline and not tracks_equal:
        raise AssertionError("serve_kitti: every match agrees, yet the tracks differ")
    score_err = float(np.abs(tg[:, 1] - tc[:, 1]).max()) if tracks_equal and len(tg) else None
    if tracks_equal and not score_err <= 1e-5:
        raise AssertionError(f"serve_kitti: track scores differ by {score_err} > 1e-5")
    return {"phase": "serve_kitti", "model": f"{m['name']}-{m['version']}", "nc": nc,
            "frame": list(KITTI_FRAME), "img_size": img_size, "input": [288, 960],
            "dtype": "bf16" if dtype == torch.bfloat16 else "f32", "settings": settings,
            "lowered": lowered, "frames": frames, "ms_p50": statistics.median(times),
            "ms_all": times, "tracks_alive": alive,
            "tracks_stored": int(len(tracker.tracks)), "track_count": tracker.track_count,
            "keypoints_per_frame": [int(o["kp_valid"].sum()) for o in outs],
            "boxes_per_frame": [int(o["box_valid"].sum()) for o in outs],
            "card_vs_cpu": {"keypoints": [ck["keypoints"] for ck in checks],
                            "descriptor_max_abs": max(ck["descriptor_max_abs"] for ck in checks),
                            "boxes": [ck["boxes"] for ck in checks],
                            "boxes_conf_0.001": low,
                            "matches": [mt["matches"] for mt in matches],
                            "borderline_match_decisions": borderline,
                            "margin_bound": max(mt["bound"] for mt in matches),
                            "tracks": [int(len(tg)), int(len(tc))],
                            "tracks_equal": bool(tracks_equal),
                            "track_score_max_abs": score_err},
            "launches": launches}, launches


# model, version, classes: the families served at the bench.py operating point
FAMILIES = (("YOLOv8Point", "s", 80), ("YOLOPointDet", "s", 80), ("SuperPointNet", None, 80))
BOX_KEYS = {"boxes", "box_scores", "box_classes", "box_valid", "box_n_candidates"}


@torch.inference_mode()
def serve_families(seed: int, batches=(1, 16), device: str = "cuda"):
    """`FAMILIES` through `InferencePipeline` at the `bench.py` operating
    point (`SERVE_CONFIG`), 640x640 uint8, bf16 (BN folded where there is
    BN), seeded random weights: one request at each batch size a family,
    after a warm-up of each. Checks that the outputs hold exactly the JAX
    pipeline's keys (box keys for `YOLOv8Point` only), one K1 and K3 launch
    a request, one K2 launch a `YOLOv8Point` request and none for the
    others; then the decode of the batch-16 request's raw outputs on the
    card against the CPU (`compare_decodes`)."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.ops import _build

    gen = torch.Generator().manual_seed(seed + 13)
    frames = {B: torch.randint(0, 256, (B, 640, 640, 3), dtype=torch.uint8, generator=gen)
              for B in batches}
    pipes = {}
    for name, version, nc in FAMILIES:
        model = folded_model(name, version or "s", seed, torch.bfloat16, device, nc)
        pipes[name] = InferencePipeline(model, SERVE_CONFIG, compute_dtype=torch.bfloat16,
                                        device=device)
        for B in batches:
            pipes[name](frames[B])
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    lat, outs = {}, {}
    for name, pipe in pipes.items():
        for B in batches:
            t0 = time.perf_counter()
            out = pipe(frames[B])
            torch.cuda.synchronize()
            lat.setdefault(name, {})[str(B)] = (time.perf_counter() - t0) * 1e3
            outs[name, B] = out
    launches = dict(_build.launch_counts)
    n = len(batches)
    want = {"nms_tile_keys": n * len(FAMILIES), "sample_descriptors": n * len(FAMILIES),
            "greedy_nms_keep": n}
    if {k: launches.get(k, 0) for k in want} != want or launches.get("K6", 0):
        raise AssertionError(f"serve_families: launches {launches}, want {want}")
    result = {}
    for name, version, nc in FAMILIES:
        pipe = pipes[name]
        has_boxes = hasattr(pipe.model, "Detect")
        for B in batches:
            keys = set(outs[name, B])
            expect = {"keypoints", "kp_scores", "kp_valid", "descriptors"}
            if keys != (expect | BOX_KEYS if has_boxes else expect):
                raise AssertionError(f"serve_families {name}: keys {sorted(keys)}")
            for k, v in outs[name, B].items():
                if v.is_floating_point() and not torch.isfinite(v).all():
                    raise AssertionError(f"serve_families {name} B={B}: {k} is not finite")
        B = batches[-1]
        raw = pipe.forward(frames[B].to(device))
        g, c = decode_both(pipe, raw)
        result[name] = {"version": version, "nc": nc if has_boxes else None,
                        "latency_ms": lat[name],
                        "descriptor_dim": int(outs[name, B]["descriptors"].shape[-1]),
                        "card_vs_cpu": compare_decodes(g, c, f"serve_families {name}")}
    return {"phase": "serve_families", "input": [640, 640], "dtype": "bf16",
            "config": SERVE_CONFIG, "families": result, "launches": launches}, launches


# ---------------------------------------------------------------- HPatches

HPATCHES_SIZE = (256, 320)
HPATCHES_SCENES = 2


def write_ppm(path: Path, bgr) -> None:
    """A binary PPM of a uint8 `(H, W, 3)` BGR numpy image, as `cv2.imwrite`
    writes it (`data.netpbm`)."""
    from yolopoint_tpu_torch.data.netpbm import write_ppm as write

    write(path, bgr)


def _png_filter(ftype: int, line, prev, bpp: int):
    """One scanline (int32 bytes) filtered by PNG filter `ftype` against the
    reconstructed row above (`prev`)."""
    left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(line)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (left + prev) >> 1
    else:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return ((line - pred) & 255).astype(np.uint8)


def encode_png(samples, color: int, depth: int = 8, filters=(0, 1, 2, 3, 4),
               palette=None, interlace: bool = False) -> bytes:
    """A PNG file of `samples` `(H, W, channels)` (values below 2**depth;
    uint16 at depth 16) in colour type `color`, row y filtered by
    `filters[y % len(filters)]`, with zlib for the deflate stream: a small
    encoder that uses every filter type, for the reader's tests. With
    `interlace`, Adam7: the seven passes' sub-images one after another, each
    filtered on its own."""
    import struct
    import zlib

    from yolopoint_tpu_torch.data.png import ADAM7

    samples = np.asarray(samples)
    H, W, C = samples.shape
    bpp = max(1, C * depth // 8)
    out = bytearray()
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        h, w = sub.shape[:2]
        if not h or not w:
            continue
        if depth == 16:
            rows = sub.astype(">u2").view(np.uint8).reshape(h, w * C * 2)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(h, w * C)
        else:  # 1, 2, 4 bits, one channel: most significant bits first, rows padded
            per = 8 // depth
            vals = np.zeros((h, -(-w // per) * per), np.uint8)
            vals[:, :w] = sub[..., 0]
            shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
            rows = (vals.reshape(h, -1, per) << shifts).sum(axis=2).astype(np.uint8)
        prev = np.zeros(rows.shape[1], np.int32)
        for y in range(h):
            line = rows[y].astype(np.int32)
            ftype = filters[y % len(filters)]
            out += bytes([ftype]) + _png_filter(ftype, line, prev, bpp).tobytes()
            prev = line

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color,
                                                             0, 0, int(interlace)))
    if palette is not None:
        data += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return data + chunk(b"IDAT", zlib.compress(bytes(out), 6)) + chunk(b"IEND", b"")


def encode_bmp_rle(rng: np.random.Generator, W: int, H: int, bpp: int = 8) -> bytes:
    """A run-length coded BMP (`BI_RLE8` at bpp 8, `BI_RLE4` at 4) of random
    codes over a random palette: encoded and absolute runs that fit their
    rows, ends of line (also on an empty row, and after a run that ended its
    row), deltas, and an end of bitmap where the codes stop early. The
    cursor is tracked as OpenCV's decoder moves it: an RLE8 encoded run that
    reaches the row's end moves on to the next row; a delta skips dx + dy *
    width pixels in row order (RLE4: dx); an RLE4 end of bitmap ends only its
    row, as OpenCV 5 reads it, so the codes go on."""
    import struct

    palette = rng.integers(0, 256, (1 << bpp, 4), dtype=np.uint8)
    out, x, y, wrapped = bytearray(), 0, 0, False
    while y < H:
        r = rng.random()
        if r < 0.03:  # end of bitmap: the rest of the image takes palette entry 0
            out += b"\x00\x01"
            if bpp == 8:
                break
            x, y, wrapped = 0, y + 1, False  # OpenCV 5's RLE4: the rest of the row
            continue
        if r < 0.1:  # delta
            dx, dy = int(rng.integers(0, 256)), int(rng.integers(0, 3))
            out += bytes([0, 2, dx, dy])
            pos = y * W + x + dx + (dy * W if bpp == 8 else 0)
            y, x, wrapped = pos // W, pos % W, False
            continue
        if r < 0.2 or x == W:  # end of line
            out += b"\x00\x00"
            if not (bpp == 8 and wrapped):  # RLE8 ignores it after a run that ended the row
                x, y = 0, y + 1
            wrapped = False
            continue
        n = int(rng.integers(1, min(W - x, 255) + 1))
        if n >= 3 and rng.random() < 0.4:  # absolute run, padded to a word
            idx = rng.integers(0, 1 << bpp, n)
            if bpp == 8:
                body = bytes(idx.astype(np.uint8)) + b"\x00" * (n & 1)
            else:
                pairs = np.concatenate([idx, [0]])[:(n + 1) // 2 * 2].reshape(-1, 2)
                body = bytes((pairs[:, 0] << 4 | pairs[:, 1]).astype(np.uint8))
                body += b"\x00" * (len(body) & 1)
            out += bytes([0, n]) + body
            x, wrapped = x + n, False
        else:  # encoded run
            out += bytes([n, int(rng.integers(0, 256))])
            x += n
            wrapped = bpp == 8 and x == W
            if wrapped:
                x, y = 0, y + 1
    pal = palette.tobytes()
    dib = struct.pack("<IiiHHIIiiII", 40, W, H, 1, bpp, 1 if bpp == 8 else 2, len(out),
                      2835, 2835, 1 << bpp, 0)
    offset = 14 + len(dib) + len(pal)
    return struct.pack("<2sIHHI", b"BM", offset + len(out), 0, 0, offset) + dib + pal + bytes(out)


def encode_bmp(img: np.ndarray, bpp: int, masks=None, core: bool = False,
               compression: int | None = None) -> bytes:
    """An uncompressed BMP of a uint8 `(H, W, 3)` BGR image, stored
    bottom-up: at 1 or 4 bits the grey of each pixel quantized to 2 or 16
    levels over a palette of tinted greys (with `core` the 12-byte
    `BITMAPCOREHEADER` and 3-byte entries), at 16 bits 5-5-5 (`BI_RGB`, or
    `BI_BITFIELDS` with `masks`; 5-6-5 where `masks` say so), at 32 bits
    B, G, R, 255 (`BI_BITFIELDS` with `masks` after the info header, which
    OpenCV does not read), at 24 bits B, G, R. `compression` overrides the
    header's field."""
    import struct

    H, W = img.shape[:2]
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    palette = b""
    if bpp in (1, 4):
        n = 1 << bpp
        idx = ((b + 2 * g + r) * n) >> 10
        ramp = np.arange(n) * 255 // (n - 1)
        pal = np.stack([ramp, ramp // 2 + 64, 255 - ramp], 1).astype(np.uint8)
        palette = (pal if core else np.concatenate([pal, np.zeros((n, 1), np.uint8)], 1)).tobytes()
        bits = np.unpackbits(idx.astype(np.uint8)[..., None], axis=2)[..., 8 - bpp:]
        packed = np.packbits(bits.reshape(H, W * bpp), axis=1)
    elif bpp == 16:
        wide = masks is not None and masks[1] == 0x07E0
        t = ((r >> 3) << 11 | (g >> 2) << 5 | b >> 3) if wide else \
            ((r >> 3) << 10 | (g >> 3) << 5 | b >> 3)
        packed = np.frombuffer(t.astype("<u2").tobytes(), np.uint8).reshape(H, 2 * W)
    elif bpp == 24:
        packed = img.reshape(H, 3 * W)
    else:
        packed = np.concatenate([img, np.full((H, W, 1), 255, np.uint8)], 2).reshape(H, 4 * W)
    stride = (W * bpp + 31) // 32 * 4
    rows = np.zeros((H, stride), np.uint8)
    rows[:, :packed.shape[1]] = packed
    pixels = rows[::-1].tobytes()
    if core:
        dib = struct.pack("<IHHHH", 12, W, H, 1, bpp)
    else:
        comp = compression if compression is not None else (3 if masks is not None else 0)
        dib = struct.pack("<IiiHHIIiiII", 40, W, H, 1, bpp, comp, len(pixels), 2835, 2835, 0, 0)
        if masks is not None:
            dib += struct.pack("<III", *masks)
    offset = 14 + len(dib) + len(palette)
    return (struct.pack("<2sIHHI", b"BM", offset + len(pixels), 0, 0, offset) + dib + palette
            + pixels)


def encode_netpbm(img: np.ndarray, kind: int, maxval: int = 255, comment: bool = False) -> bytes:
    """A `P1`-`P6` file of a uint8 `(H, W, 3)` BGR image: bitmaps (`P1`,
    `P4`) of its green channel above 127, grey maps (`P2`, `P5`) of its green
    channel, pixmaps (`P3`, `P6`) of its RGB, samples scaled to `maxval`
    (binary samples 16-bit big-endian above 255), ASCII ones 12 a line; with
    `comment`, `#` comments in the header."""
    H, W = img.shape[:2]
    head = b"P%d\n" % kind + (b"# written by chip_smoke\n" if comment else b"")
    head += b"%d %d\n" % (W, H)
    if kind in (1, 4):
        bits = (img[..., 1] > 127).astype(np.uint8)
        if kind == 1:
            return head + b"\n".join(b" ".join(b"%d" % v for v in row) for row in bits) + b"\n"
        return head + np.packbits(bits, axis=1).tobytes()
    head += (b"# maxval\n" if comment else b"") + b"%d\n" % maxval
    samples = img[..., 1] if kind in (2, 5) else img[..., ::-1]
    vals = (samples.astype(np.int64) * maxval + 127) // 255
    if kind in (2, 3):
        flat = vals.reshape(-1)
        lines = [b" ".join(b"%d" % v for v in flat[i:i + 12]) for i in range(0, len(flat), 12)]
        return head + b"\n".join(lines) + b"\n"
    return head + vals.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def encode_sunras(img: np.ndarray, depth: int = 24, colormap: bool = False,
                  kind: int = 1) -> bytes:
    """A Sun raster file of a uint8 `(H, W, 3)` BGR image: at 24 bits B, G,
    R; at 32 bits X, B, G, R; at 8 bits the green channel, through a colour
    map of tinted greys where `colormap` says so; at 1 bit the green channel
    above 127. Rows padded to 16 bits; of type `kind` (0 old, 1 standard, 2
    byte-encoded: the padded rows run-length coded, runs of 3 and more as
    `80 n-1 v` and a byte 80 as `80 00`)."""
    H, W = img.shape[:2]
    if depth == 1:
        rows = np.packbits((img[..., 1] > 127).astype(np.uint8), axis=1)
    elif depth == 8:
        rows = img[..., 1]
    elif depth == 24:
        rows = img.reshape(H, 3 * W)
    else:
        rows = np.concatenate([np.zeros((H, W, 1), np.uint8), img], 2).reshape(H, 4 * W)
    pitch = ((W * depth + 7) // 8 + 1) & ~1
    pixels = np.zeros((H, pitch), np.uint8)
    pixels[:, :rows.shape[1]] = rows
    cmap = b""
    if colormap:
        n = 1 << depth
        ramp = np.arange(n) * 255 // (n - 1)
        cmap = np.stack([ramp, ramp // 2 + 64, 255 - ramp]).astype(np.uint8).tobytes()  # R, G, B
    body = pixels.tobytes()
    if kind == 2:
        coded, i = bytearray(), 0
        while i < len(body):
            j = i
            while j < len(body) and j - i < 256 and body[j] == body[i]:
                j += 1
            if j - i >= 3 or body[i] == 0x80:
                coded += bytes([0x80, j - i - 1, body[i]]) if j - i >= 3 else b"\x80\x00"
                i = j if j - i >= 3 else i + 1
            else:
                coded.append(body[i])
                i += 1
        body = bytes(coded)
    head = np.array([0x59A66A95, W, H, depth, len(body), kind, 1 if cmap else 0, len(cmap)],
                    ">u4").tobytes()
    return head + cmap + body


def encode_pam(img: np.ndarray, tupltype: str = "RGB", maxval: int = 255) -> bytes:
    """A PAM file of a uint8 `(H, W, 3)` BGR image: `RGB` (R, G, B),
    `RGB_ALPHA` (and 255), `GRAYSCALE` (the green channel),
    `GRAYSCALE_ALPHA`, `BLACKANDWHITE` (the green channel above 127, one
    sample a pixel at maxval 1); samples scaled to `maxval` (big-endian
    16-bit above 255)."""
    H, W = img.shape[:2]
    if tupltype == "BLACKANDWHITE":
        samples, maxval = (img[..., 1:2] > 127).astype(np.int64), 1
    else:
        grey = tupltype.startswith("GRAY")
        samples = img[..., 1:2] if grey else img[..., ::-1]
        samples = (samples.astype(np.int64) * maxval + 127) // 255
        if tupltype.endswith("_ALPHA"):
            samples = np.concatenate([samples, np.full((H, W, 1), maxval)], 2)
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\nTUPLTYPE %s\nENDHDR\n" % (
        W, H, samples.shape[2], maxval, tupltype.encode())
    return head + samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def encode_pfm(img: np.ndarray, scale: float = -1.0, grey: bool = False) -> bytes:
    """A PFM file of a uint8 `(H, W, 3)` BGR image's values as floats (the
    green channel with `grey`), bottom-up, R, G, B, little-endian where
    `scale` is negative; OpenCV reads the values times `1 / |scale|`."""
    v = img[..., 1:2] if grey else img[..., ::-1]
    v = v.astype(np.float32)[::-1] * np.float32(abs(scale))
    H, W = img.shape[:2]
    head = b"%s\n%d %d\n%s\n" % (b"Pf" if grey else b"PF", W, H, repr(float(scale)).encode())
    return head + v.astype("<f4" if scale < 0 else ">f4").tobytes()


def _rgbe(bgr: np.ndarray) -> np.ndarray:
    """uint8 R, G, B, E of float BGR values, as `rgbe.c`'s `float2rgbe`."""
    rgb = bgr[..., ::-1].astype(np.float64)
    v = rgb.max(-1)
    m, e = np.frexp(v)
    scale = np.where(v < 1e-32, 0.0, m * 256.0 / np.where(v < 1e-32, 1.0, v))
    out = np.zeros(bgr.shape[:-1] + (4,), np.uint8)
    out[..., :3] = (rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(v < 1e-32, 0, e + 128)
    return out


def encode_radiance(values: np.ndarray, rle: bool = True) -> bytes:
    """A Radiance picture of float `(H, W, 3)` BGR values: `#?RADIANCE`, the
    format line, `-Y H +X W`, then each scanline run-length coded as
    `rgbe.c` writes it (runs of 4 and more, literals of up to 128) where
    `rle` and the width allows (8 to 32767), else flat R, G, B, E."""
    H, W = values.shape[:2]
    px = _rgbe(values)
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (H, W)
    if not rle or not 8 <= W <= 0x7FFF:
        return head + px.tobytes()
    out = bytearray(head)
    for y in range(H):
        out += bytes([2, 2, W >> 8, W & 255])
        for c in range(4):
            v = px[y, :, c].tobytes()
            i = 0
            while i < W:
                j = i
                while j < W and j - i < 127 and v[j] == v[i]:
                    j += 1
                if j - i >= 4:  # a run
                    out += bytes([128 + j - i, v[i]])
                    i = j
                    continue
                k = i  # a literal up to the next run of 4
                while k < W and k - i < 128 and not (k + 3 < W and v[k] == v[k + 1] == v[k + 2]
                                                     == v[k + 3]):
                    k += 1
                k = max(k, i + 1)
                out += bytes([k - i]) + v[i:k]
                i = k
    return bytes(out)


def _gif_lzw(idx: np.ndarray, min_size: int, clear_every: int = 0,
             defer_full: bool = False) -> bytes:
    """GIF LZW of palette indices, least significant bit first, with
    giflib's code-size schedule; a clear code after every `clear_every`
    codes, and with `defer_full` no clear once the table is full (4096
    entries: codes stay at 12 bits)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nacc = 0
    bits, nxt, table = min_size + 1, eoi + 1, {}

    def emit(code: int) -> None:
        nonlocal acc, nacc, bits
        acc |= code << nacc
        nacc += bits
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
        if nxt >= 1 << bits and bits < 12:
            bits += 1

    emit(clear)
    seq = idx.reshape(-1).tolist()
    cur, count = seq[0], 0
    for px in seq[1:]:
        key = (cur, px)
        if key in table:
            cur = table[key]
            continue
        emit(cur)
        count += 1
        cur = px
        if (nxt >= 4095 and not defer_full) or (clear_every and count % clear_every == 0):
            emit(clear)
            table, nxt, bits = {}, eoi + 1, min_size + 1
        elif nxt < 4096:
            table[key] = nxt
            nxt += 1
    emit(cur)
    emit(eoi)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def encode_gif(idx: np.ndarray, palette: np.ndarray, screen=None, offset=(0, 0),
               local: bool = False, interlace: bool = False, transparent=None,
               background: int = 0, min_size=None, clear_every: int = 0,
               defer_full: bool = False) -> bytes:
    """A GIF89a file of one frame of palette indices `idx` (`(h, w)`) over
    `palette` (`(n, 3)` RGB, n a power of 2 up to 256): on a screen of
    `screen` (W, H; the frame's size by default) at `offset`, its table
    global or `local`, its rows interlaced, `transparent` (an index, in a
    Graphic Control Extension), the LZW of `_gif_lzw`."""
    h, w = idx.shape
    sw, sh = screen or (w, h)
    bits = max(1, int(np.ceil(np.log2(len(palette)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(palette)] = palette
    flags = 0 if local else 0x80 | (bits - 1) << 4 | (bits - 1)
    out = b"GIF89a" + np.array([sw, sh], "<u2").tobytes() + bytes([flags, background, 0])
    if not local:
        out += table.tobytes()
    if transparent is not None:
        out += b"\x21\xf9\x04\x01\x00\x00" + bytes([transparent]) + b"\x00"
    rows = idx
    if interlace:
        rows = idx[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                   np.arange(1, h, 2)])]
    out += b"\x2c" + np.array([*offset, w, h], "<u2").tobytes()
    out += bytes([(0x80 | (bits - 1) if local else 0) | (0x40 if interlace else 0)])
    if local:
        out += table.tobytes()
    size = min_size or max(2, bits)
    data = _gif_lzw(rows, size, clear_every, defer_full)
    out += bytes([size]) + b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                                    for i in range(0, len(data), 255)) + b"\x00"
    return out + b"\x3b"


def _packbits(row: bytes) -> bytes:
    """PackBits of one row: runs of 2 to 128 bytes, literals of up to 128."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 255, row[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and row[j + 1] == row[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def _tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW: codes most significant bit first, 9 to 12 bits wide (wider
    once the table reaches 512, 1024 and 2048 entries, which libtiff's
    decoder expects one code early), a clear code first and at 4094
    entries, end-of-information last."""
    out = bytearray()
    acc = nacc = 0
    bits = 9

    def emit(code: int) -> None:
        nonlocal acc, nacc
        acc = (acc << bits) | code
        nacc += bits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    def grow(n: int) -> int:
        return {512: 10, 1024: 11, 2048: 12}.get(n, bits)

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    emit(256)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = nxt
        nxt += 1
        bits = grow(nxt)
        if nxt == 4094:
            emit(256)
            table, nxt, bits = {bytes([i]): i for i in range(256)}, 258, 9
        w = bytes([b])
    if w:
        emit(table[w])
        bits = grow(nxt + 1)
    emit(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def encode_tiff(samples: np.ndarray, photometric: int, bits: int = 8, order: str = "<",
                big: bool = False, compression: int = 1, predictor: int = 1,
                rows_per_strip=None, tile=None, planar: int = 1, extra=(), colormap=None,
                subsampling=None, orientation=None, quality: int = 90,
                sample_format=None, tags=None) -> bytes:
    """A TIFF file (classic, or BigTIFF with `big`; byte order `order`) of
    the sample values `samples` (`(H, W, spp)` integers), its directory
    first: strips of `rows_per_strip` rows or tiles of `tile` (W, H), one
    plane or `planar` 2; compression none (1), LZW (5), Deflate (8), PackBits
    (32773) or JPEG (7: YCbCr 4:2:0 of RGB samples, a grey stream of one
    sample or plane, each strip or tile a whole JPEG stream from
    `encode_jpeg`; any other number over uncompressed
    data); 32-bit floats where `sample_format` is 3; predictor 2; ExtraSamples
    `extra`; a 16-bit `colormap` (`(2**bits, 3)`); YCbCr samples in
    `subsampling` blocks (the chroma of each block's first pixel);
    `orientation`; `tags` more entries or in place of these, `{tag: (type,
    values)}` (types 3 SHORT, 4 LONG, 5 RATIONAL of `(num, den)` pairs, 7
    UNDEFINED bytes)."""
    import struct
    import zlib

    samples = np.asarray(samples)
    samples = samples.astype(np.float64 if sample_format == 3 else np.int64)
    if samples.ndim == 2:
        samples = samples[..., None]
    H, W, spp = samples.shape
    blocks = photometric == 6 and planar == 1 and subsampling not in (None, (1, 1))

    def pack(a: np.ndarray) -> bytes:  # (h, w, c) -> bytes, rows padded to a byte
        h, w, c = a.shape
        if blocks:
            hs, vs = subsampling
            bh, bw = -(-h // vs), -(-w // hs)
            pad = np.zeros((bh * vs, bw * hs, 3), np.int64)
            pad[:h, :w] = a
            y = pad[..., 0].reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(bh, bw, -1)
            return np.concatenate([y, pad[::vs, ::hs, 1:3]], 2).astype(np.uint8).tobytes()
        if sample_format == 3:
            return a.astype(order + "f4").tobytes()
        if bits >= 8:
            return a.astype(order + ("u2" if bits == 16 else "u1")).tobytes()
        flat = np.unpackbits(a.reshape(h, w * c).astype(np.uint8)[..., None], axis=2)
        return np.packbits(flat[..., 8 - bits:].reshape(h, -1), axis=1).tobytes()

    def code(a: np.ndarray) -> bytes:
        if compression == 7:  # a plane of one sample: a grey JPEG stream
            rgb = a.astype(np.uint8)
            if rgb.shape[2] == 1:
                return encode_jpeg(np.ascontiguousarray(rgb[..., 0]), quality, "420")
            return encode_jpeg(np.ascontiguousarray(rgb[..., ::-1]), quality, "420")
        if predictor == 2:
            a = a.copy()
            a[:, 1:] = (a[:, 1:] - a[:, :-1]) % (1 << bits)
        raw = pack(a)
        if compression == 5:
            return _tiff_lzw(raw)
        if compression == 8:
            return zlib.compress(raw)
        if compression == 32773:
            step = len(raw) // a.shape[0]
            return b"".join(_packbits(raw[i:i + step]) for i in range(0, len(raw), step))
        return raw

    planes = [samples] if planar == 1 else [samples[..., i:i + 1] for i in range(spp)]
    chunks = []
    for p in planes:
        if tile is None:
            rps = rows_per_strip or H
            chunks += [code(p[y:y + rps]) for y in range(0, H, rps)]
        else:
            tw, th = tile
            for y in range(0, H, th):
                for x in range(0, W, tw):
                    t = np.zeros((th, tw, p.shape[2]), p.dtype)
                    part = p[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(code(t))
    entries = {256: (4, [W]), 257: (4, [H]), 258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, np.asarray(colormap, np.int64).T.reshape(-1).tolist())
    if subsampling is not None:
        entries[530] = (3, list(subsampling))
    if orientation is not None:
        entries[274] = (3, [orientation])
    if sample_format is not None:
        entries[339] = (3, [sample_format] * spp)
    long_t = 16 if big else 4
    if tile is None:
        entries[278] = (4, [rows_per_strip or H])
        offs_tag, counts_tag = 273, 279
    else:
        entries[322], entries[323] = (4, [tile[0]]), (4, [tile[1]])
        offs_tag, counts_tag = 324, 325
    entries[counts_tag] = (long_t, [len(c) for c in chunks])
    entries[offs_tag] = (long_t, [0] * len(chunks))
    entries.update(tags or {})
    fmt = {3: "H", 4: "I", 16: "Q"}
    inline, entry = (8, 20) if big else (4, 12)
    first = 16 if big else 8
    ifd_size = (8 if big else 2) + len(entries) * entry + (8 if big else 4)

    def directory(data_at: int) -> tuple[bytes, bytes]:
        ifd = struct.pack(order + ("Q" if big else "H"), len(entries))
        values, at = b"", first + ifd_size
        for t in sorted(entries):
            typ, vals = entries[t]
            if typ == 7:
                raw = bytes(vals)
            elif typ == 5:
                raw = b"".join(struct.pack(order + "II", *v) for v in vals)
            else:
                raw = struct.pack(order + fmt[typ] * len(vals), *vals)
            if len(raw) <= inline:
                field = raw + bytes(inline - len(raw))
            else:
                field = struct.pack(order + ("Q" if big else "I"), at + len(values))
                values += raw + bytes(len(raw) & 1)
            ifd += struct.pack(order + ("HHQ" if big else "HHI"), t, typ, len(vals)) + field
        return ifd + bytes(8 if big else 4), values

    _, values = directory(0)
    data_at = first + ifd_size + len(values)
    offsets = np.cumsum([data_at] + [len(c) for c in chunks])[:-1]
    if offs_tag not in (tags or {}):
        entries[offs_tag] = (long_t, [int(o) for o in offsets])
    ifd, values = directory(data_at)
    magic = b"II" if order == "<" else b"MM"
    head = magic + (struct.pack(order + "HHHQ", 43, 8, 0, first) if big
                    else struct.pack(order + "HI", 42, first))
    return head + ifd + values + b"".join(chunks)


# the standard's Annex K.1 quantization tables (natural order): luminance,
# chrominance; scaled by quality as libjpeg's `jpeg_quality_scaling`
JPEG_QUANT = (
    (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99),
    (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, *[99] * 38),
)
# luminance (h, v) sampling factors of each layout; chroma is 1x1
JPEG_SAMPLING = {"420": (2, 2), "422": (2, 1), "440": (1, 2), "444": (1, 1), "411": (4, 1)}


def _jpeg_segment(marker: int, body: bytes) -> bytes:
    import struct

    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _exif_app1(orientation: int) -> bytes:
    """An APP1 segment whose IFD0 holds only the orientation (big-endian TIFF)."""
    import struct

    tiff = b"MM" + struct.pack(">HI", 42, 8) + struct.pack(">H", 1) \
        + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(">I", 0)
    return _jpeg_segment(0xE1, b"Exif\0\0" + tiff)


def _huffman_codes(bits, values) -> tuple[np.ndarray, np.ndarray]:
    """`(code, length)` of each of the 256 symbols of a canonical table."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            code_of[values[k]], len_of[values[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _pack_bits(values: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """The bits of `values` (each `nbits` wide, most significant first) as
    bytes; the total must be a multiple of 8."""
    starts = np.cumsum(nbits) - nbits
    item = np.repeat(np.arange(len(values)), nbits)
    j = np.arange(int(nbits.sum())) - starts[item]
    return np.packbits(((values[item] >> (nbits[item] - 1 - j)) & 1).astype(np.uint8))


class QMEncoder:
    """libjpeg-turbo's `jcarith.c` `arith_encode` and `finish_pass`: the QM
    coder's encoder over `jpeg_arith.ARITAB`, with its carry handling (the
    stacked `FF` bytes, zero bytes held back, `FF 00` stuffing)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.ct, self.sc, self.zc, self.buffer = 0, 0x10000, 11, 0, 0, -1

    def _emit_carry(self, byte: int) -> None:
        self.out += b"\x00" * self.zc
        self.zc = 0
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _flush(self, temp: int) -> None:
        """A byte ready at the top of C (`temp`), as `arith_encode` outputs it."""
        if temp > 0xFF:  # a carry into the stacked bytes
            if self.buffer >= 0:
                self._emit_carry(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_carry(self.buffer)
            if self.sc:
                self.out += b"\x00" * self.zc
                self.zc = 0
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, st: list, i: int, val: int) -> None:
        from yolopoint_tpu_torch.data.jpeg_arith import ARITAB

        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:  # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:  # renormalisation and output (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._flush(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self) -> bytes:
        """The bytes of the interval, C settled to the value of most trailing
        zero bits (D.1.8)."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_carry(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush(0)  # the pending bytes, as a byte below FF would flush them
        if self.c & 0x7FFF800:
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if self.c & mask:
                    self._emit_carry((self.c >> shift) & 0xFF)
        return bytes(self.out)


def arith_scan(coefs: np.ndarray, comp: np.ndarray, segment: np.ndarray, tabs, conditioning):
    """The sequential arithmetic-coded data (`jcarith.c` `encode_mcu`) of
    blocks `coefs` (zigzag order, in coding order) of components `comp` on
    tables `tabs[comp]`, a restart marker between segments; `conditioning`:
    (L, U, Kx) of each table."""
    out, enc = bytearray(), None
    for i, blk in enumerate(coefs.tolist()):
        if enc is None or segment[i] != segment[i - 1]:
            if enc is not None:
                out += enc.finish() + bytes([0xFF, 0xD0 + (int(segment[i]) - 1) % 8])
            enc = QMEncoder()
            dc_stats = {t: [0] * 64 for t in set(tabs)}
            ac_stats = {t: [0] * 256 for t in set(tabs)}
            fixed, last_dc, context = [113], {}, {}
        ci = int(comp[i])
        t = tabs[ci]
        dc_l, dc_u, ac_k = conditioning[t]
        st, s0 = dc_stats[t], context.get(ci, 0)
        v = blk[0] - last_dc.get(ci, 0)
        if v == 0:
            enc.encode(st, s0, 0)
            context[ci] = 0
        else:
            last_dc[ci] = blk[0]
            enc.encode(st, s0, 1)
            enc.encode(st, s0 + 1, int(v < 0))
            at, context[ci], v = s0 + 2 + int(v < 0), 4 + 4 * int(v < 0), abs(v) - 1
            m = 0
            if v:
                enc.encode(st, at, 1)
                m, at = 1, 20
                v2 = v >> 1
                while v2:
                    enc.encode(st, at, 1)
                    m, at, v2 = m << 1, at + 1, v2 >> 1
            enc.encode(st, at, 0)
            if m < (1 << dc_l) >> 1:
                context[ci] = 0
            elif m > (1 << dc_u) >> 1:
                context[ci] += 8
            m >>= 1
            while m:
                enc.encode(st, at + 14, int(bool(m & v)))
                m >>= 1
        st = ac_stats[t]
        ke = 63
        while ke > 0 and not blk[ke]:
            ke -= 1
        k = 1
        while k <= ke:
            at = 3 * (k - 1)
            enc.encode(st, at, 0)  # not the end of the block
            while blk[k] == 0:
                enc.encode(st, at + 1, 0)
                at, k = at + 3, k + 1
            enc.encode(st, at + 1, 1)
            v = blk[k]
            enc.encode(fixed, 0, int(v < 0))
            v, at, m = abs(v) - 1, at + 2, 0
            if v:
                enc.encode(st, at, 1)
                m, v2 = 1, v >> 1
                if v2:
                    enc.encode(st, at, 1)
                    m, at, v2 = 2, (189 if k <= ac_k else 217), v2 >> 1
                    while v2:
                        enc.encode(st, at, 1)
                        m, at, v2 = m << 1, at + 1, v2 >> 1
            enc.encode(st, at, 0)
            m >>= 1
            while m:
                enc.encode(st, at + 14, int(bool(m & v)))
                m >>= 1
            k += 1
        if k <= 63:
            enc.encode(st, 3 * (k - 1), 1)  # end of block
    return bytes(out + enc.finish())


def encode_jpeg(img, quality: int = 90, sampling: str = "420", restart: int = 0,
                orientation: int = 0, scans=None, adobe: int | None = None,
                arithmetic: bool = False, dac: bytes = b"") -> bytes:
    """A baseline JFIF file of `img` (uint8 `(H, W, 3)` BGR, or `(H, W)` grey):
    libjpeg's RGB -> YCbCr, luminance sampled `JPEG_SAMPLING[sampling]`
    against 1x1 chroma (box-averaged), a float DCT, the Annex K tables scaled
    by `quality` and its Huffman tables, a DRI every `restart` MCUs (0:
    none), and an EXIF orientation (0: no APP1). `scans` groups the
    components into sequential scans in that order (default: one
    interleaved scan of all); a group of one is a non-interleaved scan over
    the component's own blocks. With `adobe` the file carries an Adobe
    APP14 segment of that transform in place of the JFIF APP0. A `(H, W,
    4)` `img` holds CMYK: transform 2 writes it as YCCK (libjpeg's
    `cmyk_ycck_convert`: the YCbCr of `255 - C, M, Y`, then K; Y and K
    sampled as luminance, each with the luminance tables), any other its
    four planes as they are, 1x1, on the luminance tables. With
    `arithmetic` the file is arithmetic-coded (SOF9, `arith_scan`, no DHT),
    under the conditioning of a DAC segment of `dac` where given. A small
    vectorized encoder for the decoder's checks on the card, where there is
    no `cv2`."""
    import struct

    from yolopoint_tpu_torch.data.jpeg import STD_HUFFMAN, ZIGZAG

    img = np.asarray(img, np.uint8)
    H, W = img.shape[:2]
    grey = img.ndim == 2

    def ycc(r, g, b):
        return [0.299 * r + 0.587 * g + 0.114 * b,
                -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
                0.5 * r - 0.418687589 * g - 0.081312411 * b + 128]

    if grey:
        planes = [img.astype(np.float64)]
        factors, tabs = [(1, 1)], [0]
    elif img.shape[2] == 4:
        c, m, y, k = (img[..., i].astype(np.float64) for i in range(4))
        if adobe == 2:
            planes = ycc(255 - c, 255 - m, 255 - y) + [k]
            factors = [JPEG_SAMPLING[sampling], (1, 1), (1, 1), JPEG_SAMPLING[sampling]]
            tabs = [0, 1, 1, 0]
        else:
            planes, factors, tabs = [c, m, y, k], [(1, 1)] * 4, [0] * 4
    else:
        b, g, r = (img[..., i].astype(np.float64) for i in range(3))
        planes = ycc(r, g, b)
        factors, tabs = [JPEG_SAMPLING[sampling], (1, 1), (1, 1)], [0, 1, 1]
    ntab = max(tabs) + 1
    hmax, vmax = factors[0]
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    quant = [np.clip((np.array(t) * scale + 50) // 100, 1, 255) for t in JPEG_QUANT]
    u = np.arange(8)
    dct = np.cos((2 * u[None] + 1) * u[:, None] * np.pi / 16) / 2
    dct[0] /= np.sqrt(2)
    blocks = []  # per component: (my * v, mx * h, 64) quantized, zigzag order
    for ci, (p, (h, v)) in enumerate(zip(planes, factors)):
        full = np.pad(p, ((0, my * 8 * vmax - H), (0, mx * 8 * hmax - W)), mode="edge")
        rh, rw = vmax // v, hmax // h
        sub = full.reshape(full.shape[0] // rh, rh, full.shape[1] // rw, rw).mean(axis=(1, 3))
        tiles = sub.reshape(my * v, 8, mx * h, 8).transpose(0, 2, 1, 3) - 128
        coef = dct @ tiles @ dct.T
        q = quant[tabs[ci]].reshape(8, 8)
        blocks.append(np.floor(coef / q + 0.5).astype(np.int64).reshape(my * v, mx * h, 64)
                      [..., ZIGZAG])
    codes = {key: _huffman_codes(*STD_HUFFMAN[key]) for key in STD_HUFFMAN}

    def size(v):
        a = np.abs(v)
        return np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1, 0)

    def extra(v, s):
        return np.where(v < 0, v + (1 << s) - 1, v)

    def scan_data(group) -> bytes:
        """The entropy-coded data of one scan of the components `group`."""
        if len(group) == 1:  # the component's own blocks in raster order, one an MCU
            ci = group[0]
            h, v = factors[ci]
            by, bx = -(-(-(-H * v // vmax)) // 8), -(-(-(-W * h // hmax)) // 8)
            coefs = blocks[ci][:by, :bx].reshape(-1, 64)
            comp = np.full(len(coefs), ci)
            mcu = np.arange(len(coefs))
        else:  # the MCUs' blocks: each component's v x h in turn
            order, comp, mcu = [], [], []
            for ci in group:
                h, v = factors[ci]
                rows = np.arange(my)[:, None, None, None] * v + np.arange(v)[None, None, :, None]
                cols = np.arange(mx)[None, :, None, None] * h + np.arange(h)[None, None, None, :]
                rows, cols = np.broadcast_arrays(rows, cols)
                order.append(blocks[ci][rows, cols].reshape(my * mx, v * h, 64))
                comp.append(np.full((my * mx, v * h), ci))
                mcu.append(np.broadcast_to(np.arange(my * mx)[:, None], (my * mx, v * h)))
            coefs = np.concatenate(order, axis=1).reshape(-1, 64)
            comp = np.concatenate(comp, axis=1).reshape(-1)
            mcu = np.concatenate(mcu, axis=1).reshape(-1)
        segment = mcu // restart if restart else np.zeros_like(mcu)
        if arithmetic:
            cond = [[0, 1, 5] for _ in range(16)]
            for index, val in zip(dac[0::2], dac[1::2]):
                if index >= 16:
                    cond[index - 16][2] = val
                else:
                    cond[index][:2] = [val & 15, val >> 4]
            return arith_scan(coefs, comp, segment, tabs, cond)
        table = np.asarray(tabs)[comp]
        n = len(coefs)
        # DC differences, the predictor reset at each restart
        diff = coefs[:, 0].copy()
        for ci in group:
            idx = np.nonzero(comp == ci)[0]
            prev = np.concatenate([[0], coefs[idx[:-1], 0]])
            prev[np.concatenate([[True], segment[idx[1:]] != segment[idx[:-1]]])] = 0
            diff[idx] = coefs[idx, 0] - prev
        keys, vals, lens = [], [], []

        def emit_items(key, cls, tbl, sym, value, nval):
            for t in (0, 1):
                sel = tbl == t
                code, length = codes[(cls, t)]
                keys.append(key[sel])
                vals.append((code[sym[sel]] << nval[sel]) | value[sel])
                lens.append(length[sym[sel]] + nval[sel])

        s = size(diff)
        emit_items(np.arange(n) * 4096, 0, table, s, extra(diff, s), s)
        blk, kk = np.nonzero(coefs[:, 1:])
        k = kk + 1
        v = coefs[blk, k]
        prev = np.concatenate([[0], k[:-1]])
        prev[np.concatenate([[True], blk[1:] != blk[:-1]])] = 0
        run = k - prev - 1
        s = size(v)
        emit_items(blk * 4096 + k * 8 + 7, 1, table[blk], ((run % 16) << 4) | s, extra(v, s), s)
        zrl = np.repeat(np.arange(len(k)), run // 16)
        j = np.arange(len(zrl)) - np.repeat(np.cumsum(run // 16) - run // 16, run // 16)
        emit_items(blk[zrl] * 4096 + k[zrl] * 8 + j, 1, table[blk[zrl]],
                   np.full(len(zrl), 0xF0), np.zeros(len(zrl), np.int64),
                   np.zeros(len(zrl), np.int64))
        last = np.zeros(n, np.int64)
        np.maximum.at(last, blk, k)
        eob = np.nonzero(last < 63)[0]
        emit_items(eob * 4096 + 512, 1, table[eob], np.zeros(len(eob), np.int64),
                   np.zeros(len(eob), np.int64), np.zeros(len(eob), np.int64))
        keys, vals, lens = (np.concatenate(x) for x in (keys, vals, lens))
        # each segment filled with 1-bits to a byte
        seg_of = segment[keys // 4096]
        seg_bits = np.bincount(seg_of, lens, minlength=segment.max() + 1).astype(np.int64)
        fill = (-seg_bits) % 8
        last_block = np.array([np.nonzero(segment == sg)[0][-1] for sg in range(len(seg_bits))])
        keys = np.concatenate([keys, last_block * 4096 + 4095])
        vals = np.concatenate([vals, (1 << fill) - 1])
        lens = np.concatenate([lens, fill])
        order = np.argsort(keys, kind="stable")
        packed = _pack_bits(vals[order], lens[order]).tobytes()
        data, pos = bytearray(), 0
        for sg, nb in enumerate(((seg_bits + fill) // 8).tolist()):
            if sg:
                data += bytes([0xFF, 0xD0 + (sg - 1) % 8])
            data += packed[pos:pos + nb].replace(b"\xff", b"\xff\x00")
            pos += nb
        return bytes(data)

    out = bytearray(b"\xff\xd8")
    if adobe is None:
        out += _jpeg_segment(0xE0, b"JFIF\0\x01\x01\0" + struct.pack(">HH", 1, 1) + b"\0\0")
    else:  # version 100, no flags, the transform
        out += _jpeg_segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    if orientation:
        out += _exif_app1(orientation)
    for t in range(ntab):
        out += _jpeg_segment(0xDB, bytes([t]) + quant[t].astype(np.uint8)[ZIGZAG].tobytes())
    sof = struct.pack(">BHHB", 8, H, W, len(planes))
    for ci, (h, v) in enumerate(factors):
        sof += bytes([ci + 1, (h << 4) | v, tabs[ci]])
    out += _jpeg_segment(0xC9 if arithmetic else 0xC0, sof)
    for t in range(0 if arithmetic else ntab):
        for cls in (0, 1):
            bits, values = STD_HUFFMAN[(cls, t)]
            out += _jpeg_segment(0xC4, bytes([(cls << 4) | t, *bits]) + bytes(values))
    if dac:
        out += _jpeg_segment(0xCC, dac)
    if restart:
        out += _jpeg_segment(0xDD, struct.pack(">H", restart))
    for group in scans or [tuple(range(len(planes)))]:
        sos = bytes([len(group)])
        for ci in group:
            sos += bytes([ci + 1, (tabs[ci] << 4) | tabs[ci]])
        out += _jpeg_segment(0xDA, sos + b"\x00\x3f\x00") + scan_data(group)
    return bytes(out + b"\xff\xd9")


def _jpeg_segments(data: bytes) -> tuple[list[tuple[int, bytes]], bytes]:
    """The marker segments of a JPEG file up to its first SOS (`(marker,
    body)`, SOI not included) and the rest of the file from that SOS on."""
    import struct

    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((data[pos + 1], data[pos + 4:pos + 2 + length]))
        pos += 2 + length
    return out, data[pos:]


def patch_jpeg(data: bytes, sof: int, ss: int | None = None, se: int | None = None,
               al: int | None = None, precision: int | None = None, dac: bytes = b"") -> bytes:
    """A file of `encode_jpeg` read under another coding process: its SOF
    marker made `sof`, the frame's precision and its first scan's Ss, Se and
    Al (Ah 0) set where given, a DAC segment of `dac` before the SOS where
    given; the entropy-coded bytes kept. Any byte string is an
    arithmetic-coded scan (SOF9), and a Huffman scan's bits read on as a
    lossless scan's differences (SOF3); `cv2.imread` decodes both."""
    head, rest = _jpeg_segments(data)
    out = bytearray(b"\xff\xd8")
    for marker, body in head:
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            marker = sof
            if precision is not None:
                body = bytes([precision]) + body[1:]
        out += _jpeg_segment(marker, body)
    if dac:
        out += _jpeg_segment(0xCC, dac)
    sos = bytearray(rest[4:4 + int.from_bytes(rest[2:4], "big") - 2])
    n = sos[0]
    for i, v in ((1 + 2 * n, ss), (2 + 2 * n, se), (3 + 2 * n, al)):
        if v is not None:
            sos[i] = v
    return bytes(out + _jpeg_segment(0xDA, bytes(sos)) + rest[2 + 2 + len(sos):])


# libjpeg's default progressive script of a YCbCr file (jcparam.c
# `jpeg_simple_progression`): (components, Ss, Se, Ah, Al) a scan
PROGRESSIVE_SCRIPT = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                      ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                      ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                      ((0,), 1, 63, 1, 0))
# a DAC segment: DC tables 0 and 1 conditioned (L, U) = (2, 4) and (0, 0), AC
# table 0 and 1's Kx 12 and 2 (the defaults are (0, 1) and 5)
ARITH_DAC = bytes([0x00, 0x42, 0x01, 0x00, 0x10, 12, 0x11, 2])


def progressive_arith_jpeg(base: bytes, rng: np.random.Generator, payload: int = 64,
                           restart: int = 0, dac: bytes = b"", cut: int = 0) -> bytes:
    """A progressive arithmetic-coded file (SOF10) of `base`'s frame and
    tables (a file of `encode_jpeg`): `PROGRESSIVE_SCRIPT` over the frame's
    components, each scan `payload` seeded random bytes (`FF` stuffed, a
    restart marker every `payload // 4` bytes where `restart` sets a DRI),
    the last `cut` scans left out (libjpeg-turbo then smooths the blocks)."""
    head, _ = _jpeg_segments(base)
    out = bytearray(b"\xff\xd8")
    ncomp = 0
    for marker, body in head:
        if marker == 0xC0:
            marker, ncomp = 0xCA, body[5]
        out += _jpeg_segment(marker, body)
    if dac:
        out += _jpeg_segment(0xCC, dac)
    if restart:
        out += _jpeg_segment(0xDD, restart.to_bytes(2, "big"))
    script = [(tuple(c for c in comps if c < ncomp), *band) for comps, *band in PROGRESSIVE_SCRIPT]
    script = [sc for sc in script if sc[0]]
    for comps, ss, se, ah, al in script[:len(script) - cut]:
        sos = bytes([len(comps)]) + b"".join(bytes([c + 1, 0x11 * min(c, 1)]) for c in comps)
        out += _jpeg_segment(0xDA, sos + bytes([ss, se, ah << 4 | al]))
        chunks = rng.integers(0, 256, payload, dtype=np.uint8).tobytes()
        step = payload // 4 if restart else payload
        for i, at in enumerate(range(0, payload, step)):
            if i:
                out += bytes([0xFF, 0xD0 + (i - 1) % 8])
            out += chunks[at:at + step].replace(b"\xff", b"\xff\x00")
    return bytes(out + b"\xff\xd9")


def encode_lossless(img: np.ndarray, predictor: int = 1, al: int = 0, restart_rows: int = 0,
                    precision: int = 8, sampling: str = "444", scans=None) -> bytes:
    """A lossless file (SOF3) of a uint8 image: `(H, W)` grey, `(H, W, 3)`
    BGR stored as R, G, B (component IDs 1, 2, 3 and no JFIF segment, which
    libjpeg-turbo reads as RGB in lossless mode) or `(H, W, 4)` CMYK, each
    sample below `2 ** precision`. The first component sampled
    `JPEG_SAMPLING[sampling]` against 1x1 for the others (their planes the
    image's channels at every `v`-th row and `h`-th column); `scans` groups
    the components into scans (default: one interleaved scan of all). Each
    plane shifted right by the point transform `al`, predicted as the
    standard's predictor `predictor` (1-7; the first row of a scan and of
    each restart interval from the left sample, its first sample from
    `2 ** (precision - al - 1)`, the first column from the sample above),
    the differences Huffman coded on Annex K's luminance DC table in scan
    order (an interleaved scan's MCUs padded with zero differences past the
    planes), a restart every `restart_rows` MCU rows (one scan only)."""
    from yolopoint_tpu_torch.data.jpeg import STD_HUFFMAN

    img = np.asarray(img)
    H, W = img.shape[:2]
    chans = [img] if img.ndim == 2 else ([img[..., 2], img[..., 1], img[..., 0]]
                                         if img.shape[2] == 3 else list(np.moveaxis(img, 2, 0)))
    factors = [JPEG_SAMPLING[sampling]] + [(1, 1)] * (len(chans) - 1) if len(chans) > 1 \
        else [(1, 1)]
    hmax, vmax = factors[0]
    mx, my = -(-W // hmax), -(-H // vmax)
    planes, diffs = [], []
    for ci, ((h, v), ch) in enumerate(zip(factors, chans)):
        rh, rw = vmax // v, hmax // h
        x = np.asarray(ch[::rh, ::rw], np.int64) >> al  # (ceil(H v / vmax), ceil(W h / hmax))
        planes.append(x)
        pad = np.pad(x, ((1, 0), (1, 0)))
        ra, rb, rc = pad[1:, :-1], pad[:-1, 1:], pad[:-1, :-1]  # left, above, above-left
        pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
        rows = np.arange(x.shape[0])
        # a scan's start and each restart: the first row of an MCU row (an
        # interleaved scan's MCU row is v rows of the component)
        per = (1 if scans and len(scans) > 1 else v)
        first = (rows % (restart_rows * per) == 0) if restart_rows else rows == 0
        pred[:, 0] = rb[:, 0]
        pred[first] = ra[first]
        pred[first, 0] = 1 << (precision - al - 1)
        diffs.append(((x - pred + 32768) & 0xFFFF) - 32768)
    code, length = _huffman_codes(*STD_HUFFMAN[(0, 0)])

    def coded(d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        size = np.zeros_like(d)
        a = np.abs(d)
        while (a >> size).any():
            size += (a >> size) > 0
        return ((code[size] << size) | np.where(d < 0, d + (1 << size) - 1, d),
                length[size] + size)

    data = bytearray()
    out = bytearray(b"\xff\xd8")
    out += _jpeg_segment(0xDB, bytes(65))  # never read: lossless files have no DCT
    out += _jpeg_segment(0xC3, bytes([precision]) + H.to_bytes(2, "big") + W.to_bytes(2, "big")
                         + bytes([len(chans)]) + b"".join(bytes([c + 1, (h << 4) | v, 0])
                                                          for c, (h, v) in enumerate(factors)))
    bits, values = STD_HUFFMAN[(0, 0)]
    out += _jpeg_segment(0xC4, bytes([0, *bits]) + bytes(values))
    groups = scans or [tuple(range(len(chans)))]
    if restart_rows:
        row = mx if len(groups[0]) > 1 else planes[groups[0][0]].shape[1]
        out += _jpeg_segment(0xDD, (restart_rows * row).to_bytes(2, "big"))
    for group in groups:
        if len(group) == 1:  # the component's own samples, a sample an MCU
            d = diffs[group[0]]
        else:  # each MCU: every component's v x h samples in turn, zero past the planes
            blocks = []
            for ci in group:
                h, v = factors[ci]
                pad = np.zeros((my * v, mx * h), np.int64)
                pad[:diffs[ci].shape[0], :diffs[ci].shape[1]] = diffs[ci]
                blocks.append(pad.reshape(my, v, mx, h).transpose(0, 2, 1, 3).reshape(my, mx, -1))
            d = np.concatenate(blocks, axis=2)
        vals, lens = coded(d.reshape(d.shape[0], -1))
        step = restart_rows or d.shape[0]
        for r0 in range(0, d.shape[0], step):
            v, n = vals[r0:r0 + step].ravel(), lens[r0:r0 + step].ravel()
            fill = int(-n.sum() % 8)
            packed = _pack_bits(np.append(v, (1 << fill) - 1), np.append(n, fill)).tobytes()
            if r0:
                data += bytes([0xFF, 0xD0 + (r0 // step - 1) % 8])
            data += packed.replace(b"\xff", b"\xff\x00")
        sos = bytes([len(group)]) + b"".join(bytes([c + 1, 0x00]) for c in group)
        out += _jpeg_segment(0xDA, sos + bytes([predictor, 0, al])) + data
        data = bytearray()
    return bytes(out + b"\xff\xd9")


def cut_scan(data: bytes, keep: int) -> bytes:
    """A truncated file of `data` (one scan): its entropy-coded bytes cut to
    the first `keep` (a stuffed `FF 00` not split), then EOI."""
    _, rest = _jpeg_segments(data)
    sos = 2 + int.from_bytes(rest[2:4], "big")
    body = rest[sos:sos + keep]
    return data[:len(data) - len(rest) + sos] + body.removesuffix(b"\xff") + b"\xff\xd9"


# a lossless DC table of 16-bit codes only, the all-zero code symbol 15: zero
# bits decode to 31 bits a sample
DHT_16BIT = bytes([0] + [0] * 15 + [17] + [15] + list(range(15)) + [16])


def two_component_jpeg(img: np.ndarray) -> bytes:
    """A sequential file of two components (libjpeg infers no colour space:
    `cv2.imread` returns None): `img`'s 4:4:4 file of one scan a component
    with its frame cut to Y and Cb and its last scan dropped."""
    data = encode_jpeg(img, 90, "444", scans=[(0,), (1,), (2,)])
    head, rest = _jpeg_segments(data)
    out = bytearray(b"\xff\xd8")
    for marker, body in head:
        if marker == 0xC0:
            body = body[:5] + b"\x02" + body[6:12]
        out += _jpeg_segment(marker, body)
    last = rest.rindex(b"\xff\xda")
    return bytes(out + rest[:last] + b"\xff\xd9")


JPEG_KIND_SIZE = (37, 53)  # small: the CPU tests decode these in Python


def jpeg_kind_cases(seed: int) -> list[tuple[str, bytes, np.ndarray | None]]:
    """The arithmetic-coded and lossless files that the `jpeg` phase holds
    (compiled decoder against numpy) and `tests/test_torch_image_kinds.py`
    holds (numpy against `cv2.imread`): `(name, bytes, what was encoded)`,
    the last None for files whose bytes were not encoded from an image.
    SOF9 by `encode_jpeg(arithmetic=True)` at every sampling layout and
    grey, with restart intervals 0, 1 and 3, and under a DAC segment; a
    Huffman file's bytes read as SOF9; SOF10 (`progressive_arith_jpeg`) at
    4:2:0, 4:4:4 and grey with restarts, DC and AC refinement, cut before
    its last scans; lossless (SOF3) by `encode_lossless`: grey at
    predictors 1-7 and point transforms 0 and 2, with restarts and at 4-bit
    precision, RGB at 4:4:4, 4:2:0 and 4:1:1 in one scan and in one scan a
    component, CMYK; a Huffman file's bytes read as lossless differences
    (which run out of data); and grey lossless files 20000 and 2000 wide cut
    short, mid-row, at a restart and under `DHT_16BIT`."""
    rng = np.random.default_rng(seed)
    H, W = JPEG_KIND_SIZE
    cases = []
    for sampling in (*JPEG_SAMPLING, "grey"):
        img = smooth_frame(rng, H, W)
        src = img[..., 0] if sampling == "grey" else img
        layout = "420" if sampling == "grey" else sampling
        for restart in (0, 1, 3):
            cases.append((f"sof9_{sampling}_rst{restart}", encode_jpeg(
                src, 90, layout, restart, arithmetic=True), src))
    img = smooth_frame(rng, H, W)
    cases.append(("sof9_dac", encode_jpeg(img, 90, "420", 2, arithmetic=True, dac=ARITH_DAC),
                  img))
    cases.append(("sof9_huffman_bytes", patch_jpeg(encode_jpeg(img, 90, "422", 3), 0xC9), None))
    for sampling in ("420", "444", "grey"):
        src = img[..., 0] if sampling == "grey" else img
        base = encode_jpeg(src, 90, "420" if sampling == "grey" else sampling)
        for restart, cut, dac in ((0, 0, b""), (2, 0, ARITH_DAC), (2, 3, b"")):
            cases.append((f"sof10_{sampling}_rst{restart}_cut{cut}",
                          progressive_arith_jpeg(base, rng, 160, restart, dac, cut), None))
    grey = smooth_frame(rng, H, W)[..., 1]
    huffman = encode_jpeg(grey, 90)
    for predictor in range(1, 8):
        for al in (0, 2):
            cases.append((f"sof3_p{predictor}_al{al}", encode_lossless(grey, predictor, al), grey))
            cases.append((f"sof3_huffman_bytes_p{predictor}_al{al}",
                          patch_jpeg(huffman, 0xC3, predictor, 0, al), None))
    cases.append(("sof3_p4_restarts", encode_lossless(grey, 4, 0, 5), grey))
    cases.append(("sof3_4bit_p6", encode_lossless(grey >> 4, 6, 1, 0, 4), grey >> 4))
    img = smooth_frame(rng, H, W)
    for predictor, al, sampling, scans in ((1, 0, "444", None), (5, 1, "444", [(0,), (1,), (2,)]),
                                           (7, 0, "420", None), (3, 2, "411", [(0,), (1, 2)])):
        cases.append((f"sof3_rgb_{sampling}_p{predictor}_al{al}_scans{len(scans or [0])}",
                      encode_lossless(img, predictor, al, 2 if scans is None else 0, 8, sampling,
                                      scans), img if sampling == "444" else None))
    cmyk = np.concatenate([img, smooth_frame(rng, H, W)[..., :1]], 2)
    cases.append(("sof3_cmyk_p6", encode_lossless(cmyk, 6, 0), None))
    # rows that run out of data wider than the segment's zero padding reads
    wide = smooth_frame(rng, 3, 20000)[..., 1]
    cases.append(("sof3_cut_wide", cut_scan(encode_lossless(wide, 1), 200), None))
    data = encode_lossless(wide, 4, 0, 1)
    _, rest = _jpeg_segments(data)
    cases.append(("sof3_cut_wide_at_restart", cut_scan(data, rest.index(b"\xff\xd0") - 2
                                                      - int.from_bytes(rest[2:4], "big")), None))
    head, rest = _jpeg_segments(encode_lossless(wide[:, :2000], 7))
    cases.append(("sof3_cut_dht_16bit", cut_scan(b"\xff\xd8" + b"".join(
        _jpeg_segment(m, DHT_16BIT if m == 0xC4 else b) for m, b in head) + rest, 100), None))
    return cases


# The files of `image_kind_files` that `cv2.imread` reads in colour (the
# JAX demo serves them) and returns None for (it skips them), by stem: the
# lists `tests/test_torch_image_kinds.py` takes from the JAX demo's
# `iter_frames`, and the `demo_kinds` phase from the port's on the card.
IMAGE_KINDS_SERVED = (
    "arith_420", "arith_progressive", "bmp_16_555", "bmp_16_565", "bmp_1bit", "bmp_32_masks",
    "bmp_4bit_core", "gif", "lossless_cmyk", "lossless_rgb", "pam", "pbm", "pbm_ascii", "pfm",
    "pgm_16bit", "pgm_ascii", "ppm_16bit", "ppm_ascii", "ppm_maxval100", "radiance", "sunras",
    "tiff_grey16", "tiff_jpeg", "tiff_lzw")
IMAGE_KINDS_SKIPPED = (
    "arith_lossless", "bmp_16_masks", "bmp_png_compressed", "gif_truncated", "hierarchical",
    "jpeg_12bit", "lossless_grey", "lossless_ycc", "not_an_image", "openexr", "pam_16bit_rgb",
    "pfm_grey", "ppm_maxval0", "radiance_xyze", "sunras_rle", "tiff_float", "tiff_lzma",
    "two_components")
# grey templates of the ROS node: read (`cv2.imread(path, 0)`), and None
ROS_TEMPLATE_KINDS = {"cam2": "lossless_grey.jpg", "cam3": "pbm.ppm", "cam4": "lossless_ycc.jpg",
                      "cam5": "tiff_grey16.png"}


def image_kind_files(seed: int, H: int, W: int, names=None) -> dict[str, bytes]:
    """One file of each kind this port reads since slice 21 and of each kind
    `cv2.imread` returns None for, of a seeded `(H, W)` frame, under the JAX
    demo's suffixes (`.ppm` for every Netpbm kind: the decoder is picked by
    the first bytes): arithmetic-coded JPEG (sequential, from
    `encode_jpeg`; progressive, from `progressive_arith_jpeg`), lossless
    RGB (4:2:0) and CMYK JPEG, BMP at 1 (core header), 4, 16 (5-5-5 and
    5-6-5) and 32 bits (any masks), PBM/PGM/PPM ASCII and binary at maxval
    1, 100, 255, 1000 and 65535; and the None kinds: a one-component
    lossless JPEG (grey reads only), a three-component YCbCr lossless one
    (JFIF), hierarchical, lossless arithmetic,
    12-bit and two-component JPEG, a BMP of other 16-bit masks and one of
    PNG compression, a PPM of maxval 0, an OpenEXR signature (no decoder
    here) and a text file; since slice 22, under `.png` names (the decoder
    is picked by the first bytes), TIFF (RGB LZW with the predictor, YCbCr
    JPEG, 16-bit grey big-endian Deflate tiles), GIF, Sun raster, PAM, PFM
    and Radiance files, and the None kinds of these formats: LZMA and float
    TIFF, a cut GIF, a run-length Sun raster, a 16-bit RGB PAM without
    `TUPLTYPE`, a one-channel PFM in a colour read, an XYZE Radiance file;
    with `names`, those files only."""
    from yolopoint_tpu_torch.data.bmp import MASKS_565

    rng = np.random.default_rng(seed)
    img = smooth_frame(rng, H, W)
    scan_seed = int(rng.integers(1 << 31))  # the progressive file's payload
    base = encode_jpeg(img, 90, "420")
    makers = {
        "arith_420.jpg": lambda: encode_jpeg(img, 95, "420", 4, arithmetic=True),
        "arith_progressive.jpg": lambda: progressive_arith_jpeg(
            base, np.random.default_rng(scan_seed), 4096, 4, ARITH_DAC),
        "bmp_1bit.bmp": lambda: encode_bmp(img, 1),
        "bmp_4bit_core.bmp": lambda: encode_bmp(img, 4, core=True),
        "bmp_16_555.bmp": lambda: encode_bmp(img, 16),
        "bmp_16_565.bmp": lambda: encode_bmp(img, 16, masks=MASKS_565),
        "bmp_32_masks.bmp": lambda: encode_bmp(img, 32, masks=(0xFF, 0xFF00, 0xFF0000)),
        "pbm_ascii.ppm": lambda: encode_netpbm(img, 1),
        "pgm_ascii.ppm": lambda: encode_netpbm(img, 2, 100, comment=True),
        "ppm_ascii.ppm": lambda: encode_netpbm(img, 3),
        "pbm.ppm": lambda: encode_netpbm(img, 4),
        "pgm_16bit.ppm": lambda: encode_netpbm(img, 5, 65535),
        "ppm_maxval100.ppm": lambda: encode_netpbm(img, 6, 100),
        "ppm_16bit.ppm": lambda: encode_netpbm(img, 6, 1000, comment=True),
        "lossless_rgb.jpg": lambda: encode_lossless(img, 1, 0, 0, 8, "420"),
        "lossless_cmyk.jpg": lambda: encode_lossless(
            np.concatenate([img, img[..., 1:2]], 2), 6, 1),
        "lossless_grey.jpg": lambda: encode_lossless(img[..., 1], 4),
        "lossless_ycc.jpg": lambda: patch_jpeg(base, 0xC3, 1, 0, 0),
        "hierarchical.jpg": lambda: patch_jpeg(base, 0xC5),
        "arith_lossless.jpg": lambda: patch_jpeg(base, 0xCB),
        "jpeg_12bit.jpg": lambda: patch_jpeg(base, 0xC1, precision=12),
        "two_components.jpg": lambda: two_component_jpeg(img),
        "bmp_16_masks.bmp": lambda: encode_bmp(img, 16, masks=(0xF00, 0xF0, 0xF)),
        "bmp_png_compressed.bmp": lambda: encode_bmp(img, 24, compression=5),
        "ppm_maxval0.ppm": lambda: b"P6\n%d %d\n0\n" % (W, H) + bytes(3 * H * W),
        "openexr.ppm": lambda: b"\x76\x2f\x31\x01" + bytes(60),
        "not_an_image.png": lambda: b"a text file under an image suffix\n",
        # slice 22: TIFF, GIF, Sun raster, PAM, PFM, Radiance (under `.png`)
        "tiff_lzw.png": lambda: encode_tiff(img[..., ::-1], 2, compression=5, predictor=2,
                                            rows_per_strip=16),
        "tiff_jpeg.png": lambda: encode_tiff(img[..., ::-1], 6, compression=7,
                                             subsampling=(2, 2), rows_per_strip=16),
        "tiff_grey16.png": lambda: encode_tiff(img[..., 1:2].astype(np.int64) * 257, 1,
                                               bits=16, order=">", tile=(64, 64),
                                               compression=8),
        "gif.png": lambda: encode_gif(
            (img[..., 1] >> 4).astype(np.uint8) * 16 + (img[..., 2] >> 4),
            np.stack([np.arange(256) % 16 * 17, np.arange(256) // 16 * 17,
                      np.full(256, 128)], 1).astype(np.uint8)),
        "sunras.png": lambda: encode_sunras(img, 24),
        "pam.png": lambda: encode_pam(img, "RGB"),
        "pfm.png": lambda: encode_pfm(img, -1.0),
        "radiance.png": lambda: encode_radiance(img.astype(np.float32) / 255),
        "tiff_lzma.png": lambda: encode_tiff(img[..., ::-1], 2, compression=34925),
        "tiff_float.png": lambda: encode_tiff(img[..., ::-1] / 255, 2, bits=32,
                                              sample_format=3),
        "gif_truncated.png": lambda: encode_gif((img[..., 1] >> 6).astype(np.uint8),
                                                np.eye(4, 3, dtype=np.uint8) * 255)[:-40],
        "sunras_rle.png": lambda: encode_sunras(img, 8, kind=2),
        "pam_16bit_rgb.png": lambda: encode_pam(img, "RGB", 65535).replace(b"TUPLTYPE RGB\n", b""),
        "pfm_grey.png": lambda: encode_pfm(img, -1.0, grey=True),
        "radiance_xyze.png": lambda: encode_radiance(img.astype(np.float32) / 255).replace(
            b"rgbe", b"xyze"),
    }
    return {name: make() for name, make in makers.items() if names is None or name in names}


def write_hpatches_scenes(root: Path, seed: int, device: str = "cuda") -> int:
    """`HPATCHES_SCENES` scenes in the HPatches layout under `root`: a seeded
    grey base image `1.ppm` at `HPATCHES_SIZE`, and `2.ppm`..`6.ppm` its
    warps on the card by homographies of the port's sampler with the s640
    `warped_pair` parameters, each with its pixel homography `H_1_n`
    (`x_n = H_1_n x_1`). Returns the number of pairs."""
    from yolopoint_tpu_torch.ops.geometry import warp_image
    from yolopoint_tpu_torch.ops.homography import sample_homography_batch

    H, W = HPATCHES_SIZE
    params = s640_train_config()["data"]["augmentation"]["warped_pair"]["params"]
    gen = torch.Generator(device=device).manual_seed(seed)
    # pixel -> normalized coordinates of the warp (align corners)
    norm = torch.tensor([[2.0 / (W - 1), 0.0, -1.0], [0.0, 2.0 / (H - 1), -1.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float64)
    for s, base in enumerate(grey_images(seed, HPATCHES_SCENES, H, W)):
        scene = root / f"v_smoke{s:03d}"
        scene.mkdir(parents=True)
        write_ppm(scene / "1.ppm", base)
        homs = sample_homography_batch(gen, 5, **params)
        img = torch.from_numpy(base).to(device).float().div(255.0)
        views = warp_image(img.expand(5, H, W, 3).contiguous(), homs)
        views = views.mul(255.0).round().clamp(0, 255).to(torch.uint8).cpu().numpy()
        for n in range(2, 7):
            write_ppm(scene / f"{n}.ppm", views[n - 2])
            # view n at pixel q shows image 1 at A q: x_n = A^-1 x_1
            A = torch.linalg.inv(norm) @ homs[n - 2].cpu().double() @ norm
            h1n = torch.linalg.inv(A)
            h1n = (h1n / h1n[2, 2]).tolist()
            (scene / f"H_1_{n}").write_text("\n".join(" ".join(f"{v:.10g}" for v in row)
                                                      for row in h1n))
    return HPATCHES_SCENES * 5


def save_reference_weights(path: Path, seed: int, version: str = "n", names=None,
                           detect_bias: float = 0.0) -> None:
    """Seeded random YOLOPoint weights (default: the nc=5 s640 class names)
    saved in the reference schema (`model_state_dict`, `names`, `version`,
    `model_name`), the Detect head's objectness and class biases raised by
    `detect_bias` above their priors."""
    from yolopoint_tpu_torch.models import build_model, state_dict_to_reference

    names = names or s640_train_config()["names"]
    model = build_model("YOLOPoint", version, nc=len(names), device="cpu")
    state = raise_detect_biases(model, random_weights(model, seed), detect_bias)
    torch.save({"model_state_dict": state_dict_to_reference(state),
                "names": names, "version": version, "model_name": "YOLOPoint"}, path)


def hpatches(seed: int, root: Path, weights: Path | None, pairs: int, model: str | None = None):
    """`hpatches_runner.main` on the scenes of `write_hpatches_scenes` with
    the seeded weights of `weights` (read by the reference-schema loader),
    or, with `model` (`--model`), that family under the runner's seeded
    initialization and `--max-pairs pairs`; the CLI's default fused bf16
    path on the card, at 256x320: one warm-up pair, then the pairs. A pair's
    time is the host clock from the dataset's read of that pair to the next
    read (to the return after the last): the reads, two pipeline calls (each
    ending in a copy to the host) and the numpy metrics. Checks the metrics,
    and 2 launches a pair of K3 and the keypoint NMS: K1, since 256 and 320
    are multiples of the NMS tile (4); no K6; and of K2 for a model with a
    Detect head, none for one without; the homographies by the compiled
    RANSAC, the mean time a pair of its parts (`host_split_probes`; `rest`
    the reads, repeatability and the other metrics). Returns the phase line
    and the launches."""
    from yolopoint_tpu_torch.data import datasets
    from yolopoint_tpu_torch.evaluation import hpatches_runner
    from yolopoint_tpu_torch.ops import _build

    argv = ["--data", str(root), "--size", str(HPATCHES_SIZE[0]), str(HPATCHES_SIZE[1])]
    argv += ["--model", model, "--max-pairs", str(pairs)] if model else [
        "--weights", str(weights)]
    with contextlib.redirect_stdout(sys.stderr):  # the runner prints its own line
        hpatches_runner.main(argv + ["--max-pairs", "1"])
    torch.cuda.synchronize()
    reads, getitem = [], datasets.HPatches.__getitem__

    def timed_getitem(self, idx):
        reads.append(time.perf_counter())
        return getitem(self, idx)

    _build.launch_counts.clear()
    datasets.HPatches.__getitem__ = timed_getitem
    try:
        with contextlib.redirect_stdout(sys.stderr), host_split_probes() as probe:
            metrics = hpatches_runner.main(argv)
    finally:
        datasets.HPatches.__getitem__ = getitem
    reads.append(time.perf_counter())
    launches = dict(_build.launch_counts)
    pair_ms = [(b - a) * 1e3 for a, b in zip(reads, reads[1:])]
    if probe["compiled_calls"] <= 0:
        raise AssertionError("hpatches: no homography was estimated")
    split = {k: probe[k] / pairs for k in ("inference", "matching", "ransac")}
    split["rest"] = sum(pair_ms) / pairs - sum(split.values())
    if metrics["num_pairs"] != pairs or len(pair_ms) != pairs:
        raise AssertionError(f"hpatches: {metrics['num_pairs']} pairs, {len(pair_ms)} timed")
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad or not 0.0 <= metrics["repeatability"] <= 1.0:
        raise AssertionError(f"hpatches: metrics {metrics}")
    boxes = model is None  # the weights file's YOLOPoint has a Detect head
    want = {"nms_tile_keys": 2 * pairs, "greedy_nms_keep": 2 * pairs if boxes else 0,
            "sample_descriptors": 2 * pairs}
    if {k: launches.get(k, 0) for k in want} != want or launches.get("K6", 0):
        raise AssertionError(f"hpatches: launches {launches}, want {want} and no K6")
    return {"phase": "hpatches", "model": model or "YOLOPoint-n", "nc": 5 if boxes else None,
            "input": list(HPATCHES_SIZE),
            "dtype": "bf16 (fused)", "pairs": pairs, "metrics": metrics,
            "ms_per_pair_p50": statistics.median(pair_ms), "ms_per_pair_all": pair_ms,
            "host_split_ms_per_pair_mean": split, "ransac_calls": probe["compiled_calls"],
            "ransac": "compiled (cv2.findHomography's)", "launches": launches}, launches


# ---------------------------------------------------------------- the RANSAC homography

RANSAC_PROBLEMS = 50  # the sweep, held against cv2 by tests/test_torch_ransac.py


def _ransac_warped(rng, src, noise):
    h = np.array([[1 + rng.normal(0, .15), rng.normal(0, .15), rng.normal(0, 20)],
                  [rng.normal(0, .15), 1 + rng.normal(0, .15), rng.normal(0, 20)],
                  [rng.normal(0, 5e-4), rng.normal(0, 5e-4), 1]])
    p = np.c_[src, np.ones(len(src))] @ h.T
    return p[:, :2] / p[:, 2:] + rng.normal(0, noise, src.shape)


def ransac_problem(i: int) -> tuple[np.ndarray, np.ndarray]:
    """Problem `i` of the seeded sweep (`tests/test_torch_ransac.py` holds
    the port against `cv2` on it): 4 and 5 points, an outlier among them or
    not; collinear points; one point repeated; a run of duplicates; all
    outliers; integer keypoints, a row of them at one y; then n in [4, 300]
    with 0-90% outliers and 0.5-2 px of noise."""
    rng = np.random.default_rng(1000 + i)
    if i < 4:
        n = 4 if i < 2 else 5
        src = rng.uniform(0, 320, (n, 2))
        dst = _ransac_warped(rng, src, 1.0)
        if i % 2:
            dst[2 if n == 4 else 0] = rng.uniform(0, 320, 2)
        return src, dst
    if i == 4:
        t = np.arange(20, dtype=np.float64)
        return np.stack([10 * t, 5 * t + 3], 1), np.stack([11 * t + 2, 4 * t], 1)
    if i == 5:
        src = np.tile([[10.0, 20.0]], (12, 1))
        return src, src + 1
    if i == 6:
        src = rng.uniform(0, 320, (40, 2))
        dst = _ransac_warped(rng, src, 1.0)
        src[5:15], dst[5:15] = src[5], dst[5]
        return src, dst
    if i in (7, 8):
        n = 60 if i == 7 else 8
        return rng.uniform(0, 320, (n, 2)), rng.uniform(0, 320, (n, 2))
    if i == 9:
        src = rng.uniform(0, 320, (100, 2))
        src[:30, 1] = 100
        dst = _ransac_warped(rng, src, 1.0)
        dst[:30] = rng.uniform(0, 320, (30, 2))
        return np.round(src), np.round(dst)
    n = int(rng.integers(4, 301))
    src = rng.uniform(0, 320, (n, 2))
    dst = _ransac_warped(rng, src, rng.uniform(0.5, 2.0))
    k = int(round(rng.uniform(0.0, 0.9) * n))
    out = rng.choice(n, k, replace=False)
    dst[out] = rng.uniform(0, 320, (k, 2))
    return src, dst


def ransac_phase(seed: int) -> dict:
    """The compiled RANSAC (`yp_find_homography`) against the numpy version
    on the card's host, on the `RANSAC_PROBLEMS` problems of the sweep and
    an HPatches-sized one (300 matches, 60% outliers, 1 px): `None` in the
    same places, equal masks, H within 1e-9 of its largest entry. Times a
    call of each (host clock; the compiled one 5 times a problem)."""
    from yolopoint_tpu_torch.evaluation import homography_ransac as hr

    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 320, (300, 2))
    dst = _ransac_warped(rng, src, 1.0)
    out = rng.choice(300, 180, replace=False)
    dst[out] = rng.uniform(0, 320, (180, 2))
    problems = [ransac_problem(i) for i in range(RANSAC_PROBLEMS)] + [(src, dst)]
    numpy_ms, compiled_ms, h_rel, models = [], [], 0.0, 0
    for i, (src, dst) in enumerate(problems):
        t0 = time.perf_counter()
        want_h, want_mask = hr.find_homography_ransac(src, dst)
        numpy_ms.append((time.perf_counter() - t0) * 1e3)
        hr.find_homography_ransac_compiled(src, dst)  # the first call builds nothing: warm
        t0 = time.perf_counter()
        for _ in range(5):
            got_h, got_mask = hr.find_homography_ransac_compiled(src, dst)
        compiled_ms.append((time.perf_counter() - t0) * 1e3 / 5)
        if (got_h is None) != (want_h is None) or not np.array_equal(got_mask, want_mask):
            raise AssertionError(f"ransac: problem {i}: the compiled RANSAC's model or mask "
                                 "differs from the numpy version's")
        if want_h is not None:
            models += 1
            h_rel = max(h_rel, float(np.abs(got_h - want_h).max() / np.abs(want_h).max()))
    if not h_rel <= 1e-9:
        raise AssertionError(f"ransac: H differs by {h_rel} of its largest entry > 1e-9")
    return {"phase": "ransac", "problems": len(problems), "with_model": models,
            "masks_equal": True, "h_max_rel_diff": h_rel,
            "numpy_ms_per_call_mean": statistics.mean(numpy_ms[:-1]),
            "compiled_ms_per_call_mean": statistics.mean(compiled_ms[:-1]),
            "numpy_ms_per_call_max": max(numpy_ms[:-1]),
            "compiled_ms_per_call_max": max(compiled_ms[:-1]),
            "hpatches_sized": {"matches": 300, "outliers": 180,
                               "numpy_ms": numpy_ms[-1], "compiled_ms": compiled_ms[-1]}}


@contextlib.contextmanager
def host_split_probes():
    """Host-clock timers around the evaluation's parts, shared by the
    HPatches and validation phases: the pipeline calls with the copies of
    their outputs to the host (`inference`), the mutual matching
    (`matching`) and the homography estimate (`ransac`), in ms; the compiled
    RANSAC's calls are counted and a numpy RANSAC raises (a card run must
    take the compiled one)."""
    from yolopoint_tpu_torch.evaluation import descriptor_eval, homography_ransac, hpatches_runner
    from yolopoint_tpu_torch.frontend import InferencePipeline

    acc = {"inference": 0.0, "matching": 0.0, "ransac": 0.0, "compiled_calls": 0}

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[key] += (time.perf_counter() - t0) * 1e3
        return run

    compiled = homography_ransac.find_homography_ransac_compiled

    def counted(*args, **kwargs):
        acc["compiled_calls"] += 1
        return compiled(*args, **kwargs)

    def numpy_ransac(*args, **kwargs):
        raise AssertionError("a card run took the numpy RANSAC")

    patches = [(InferencePipeline, "__call__", timed("inference", InferencePipeline.__call__)),
               (hpatches_runner, "to_numpy", timed("inference", hpatches_runner.to_numpy)),
               (descriptor_eval, "mutual_match_np",
                timed("matching", descriptor_eval.mutual_match_np)),
               (descriptor_eval, "estimate_homography",
                timed("ransac", descriptor_eval.estimate_homography)),
               (homography_ransac, "find_homography_ransac_compiled", counted),
               (homography_ransac, "find_homography_ransac", numpy_ransac)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield acc
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


@torch.inference_mode()
def hpatches_reference(seed: int, root: Path, device: str = "cuda"):
    """One pair of the written scenes through the f32 YOLOPoint-n (TF32
    off): the forward and the heatmap (softmax) of both images on the card;
    then, from those same tensors, the keypoints (K1) and the descriptors at
    them (K3) on the card against the plain versions on the CPU, and the
    pair's metrics from each side, the card's with the compiled RANSAC, the
    CPU's with the numpy one. Keypoints equal, descriptors within 1e-5, the
    mutual matches equal, then the inlier masks equal, H within 1e-9 of its
    largest entry and every metric equal (the corner error within 1e-9
    relative). (The heatmap is shared because random weights put it near
    the 0.015 threshold, where an ulp of softmax moves keypoints.)"""
    from yolopoint_tpu_torch.data.datasets import HPatches
    from yolopoint_tpu_torch.evaluation.hpatches_runner import pair_metrics
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.ops import cells_to_heatmap, extract_keypoints, sample_descriptors

    model = build_model("YOLOPoint", "n", nc=5, device="cpu")
    random_weights(model, seed)
    pipe = InferencePipeline(model, {"detection_threshold": 0.015}, device=device)
    args = (pipe.conf_thresh, pipe.nms_radius, pipe.top_k, pipe.border)
    sample = HPatches(root, HPATCHES_SIZE)[2]
    outs = {device: [], "cpu": []}
    for k in ("image", "warped_image"):
        raw = pipe.forward(torch.from_numpy(sample[k][None]).to(device))
        heat = cells_to_heatmap(raw["semi"].float().permute(0, 2, 3, 1))
        desc = raw["desc"].permute(0, 2, 3, 1).contiguous()
        for dev in (device, "cpu"):
            pts, scores, valid = extract_keypoints(heat.to(dev), *args)
            outs[dev].append({"keypoints": pts.cpu().numpy(), "kp_scores": scores.cpu().numpy(),
                              "kp_valid": valid.cpu().numpy(), "descriptors": sample_descriptors(
                                  desc.to(dev), pts).cpu().numpy()})
    card, cpu = outs[device], outs["cpu"]
    for a, b in zip(card, cpu):
        for k in ("keypoints", "kp_scores", "kp_valid"):
            if not (a[k] == b[k]).all():
                raise AssertionError(f"hpatches_reference: {k} differ between the card and the CPU")
    desc_err = max(float(abs(a["descriptors"] - b["descriptors"]).max()) for a, b in zip(card, cpu))
    if not desc_err <= 1e-5:
        raise AssertionError(f"hpatches_reference: descriptors differ by {desc_err} > 1e-5")
    m = {name: pair_metrics(o[0], o[1], sample["homography_pix"], HPATCHES_SIZE, device=dev)
         for name, o, dev in (("card", card, device), ("cpu", cpu, "cpu"))}
    hc_g, hc_c = m["card"]["correctness"], m["cpu"]["correctness"]
    if not (hc_g["matches"].shape == hc_c["matches"].shape
            and (hc_g["matches"] == hc_c["matches"]).all()):
        raise AssertionError("hpatches_reference: the mutual matches differ")
    # the card run's compiled RANSAC against the CPU run's numpy one
    if not np.array_equal(hc_g["inliers"], hc_c["inliers"]):
        raise AssertionError("hpatches_reference: the RANSAC's inlier masks differ")
    h_rel = float(np.abs(hc_g["homography"] - hc_c["homography"]).max()
                  / np.abs(hc_c["homography"]).max())
    if not h_rel <= 1e-9:
        raise AssertionError(f"hpatches_reference: H differs by {h_rel} of its largest entry")

    def scalars(x):
        hc = x["correctness"]
        return {"repeatability": x["repeatability"], "localization_error": x["localization_error"],
                "matching_score": hc["matching_score"], "mean_dist": hc["mean_dist"],
                "match_ap": x["match_ap"]}

    got, want = scalars(m["card"]), scalars(m["cpu"])
    dist_g, dist_c = got.pop("mean_dist"), want.pop("mean_dist")
    if got != want or (dist_g is None) != (dist_c is None) or (
            dist_c is not None and not abs(dist_g - dist_c) <= 1e-9 * abs(dist_c)):
        raise AssertionError(f"hpatches_reference: metrics card {got} ({dist_g}) vs CPU "
                             f"{want} ({dist_c})")
    want["mean_dist"] = dist_c
    n_kp = [int(o["kp_valid"].sum()) for o in cpu]
    if min(n_kp) == 0 or len(hc_c["matches"]) == 0:
        raise AssertionError(f"hpatches_reference: keypoints {n_kp}, {len(hc_c['matches'])} matches")
    return {"phase": "hpatches_reference", "model": "YOLOPoint-n", "input": list(HPATCHES_SIZE),
            "dtype": "f32", "pair": sample["name"], "keypoints": n_kp,
            "matches": int(len(hc_c["matches"])), "inliers": int(np.sum(hc_c["inliers"])),
            "ransac_h_max_rel_diff": h_rel, "descriptor_max_abs": desc_err, "metrics": want}


# ---------------------------------------------------------------- export

def s640_export_config() -> dict:
    """`configs/synthetic_s640_export.yaml`, read by the port's config reader."""
    from yolopoint_tpu_torch.utils.config import load_config

    return load_config(REPO / "configs" / "synthetic_s640_export.yaml")


EXPORT_PHASES = ("views", "forward", "heatmap", "warps_back", "aggregate_nms")


def export_kwargs(num_homographies: int | None = None, cfg: dict | None = None) -> dict:
    """`homography_adaptation_batch` arguments of an export config (default
    `s640_export_config()`), as the JAX export CLI reads them."""
    cfg = cfg or s640_export_config()
    ex, sp = cfg["export"], cfg["model"]["superpoint"]
    return dict(num_homographies=num_homographies or ex["num_homographies"],
                conf_thresh=sp["detection_threshold"], nms_radius=sp["nms"], top_k=sp["top_k"],
                hom_params=ex["homography"], erosion_radius=ex["erosion_radius"])


def export_model(seed: int, device, cfg: dict | None = None):
    """An export config's model (default `s640_export_config()`: YOLOPoint-S,
    nc=5) as the JAX export CLI builds it: f32, BN unfolded, seeded random
    weights."""
    from yolopoint_tpu_torch.models import build_model

    cfg = cfg or s640_export_config()
    m = cfg["model"]
    model = build_model(m.get("name", "YOLOPointDet"), m.get("version", "s"),
                        nc=max(len(cfg.get("names", [])), 1), device="cpu")
    random_weights(model, seed)
    return model.to(device).eval()


def export(seed: int, warmup: int = 1, images: int = 4, device: str = "cuda",
           cfg: dict | None = None, size: tuple[int, int] | None = None,
           phase: str = "export"):
    """`export_pseudo_labels` at the settings of an export config (default
    `s640_export_config()`: YOLOPoint-S, 640x640, N = 50 views, f32) on
    `warmup` + `images` seeded grey images of `size` (default the config's
    `resize`) into a temporary directory. An image's time is the host
    clock from its start to the next image's (to the return after the
    last), the `.npz` write included; its CUDA-event split follows
    `EXPORT_PHASES`. Checks 3 K4 and 1 K1 launches an image, no other
    kernel; the tiles that took the warp's global branch (the kernel's
    counter, over the run) equal to those whose window exceeds the budget,
    summed over each image's three warps (`cuda_warp.window_bytes` of its
    homographies, redrawn from the same generators); and every file's `pts`
    of shape (K <= top_k, 3), 0 < K, inside the frame. Returns the phase
    line and the launches of the timed images."""
    from yolopoint_tpu_torch.export import draw_homographies, export_pseudo_labels, image_generator
    from yolopoint_tpu_torch.ops import _build, cuda_warp

    cfg = cfg or s640_export_config()
    H, W = size or cfg["data"]["preprocessing"]["resize"]
    kw = export_kwargs(cfg=cfg)
    N, top_k = kw["num_homographies"], kw["top_k"]
    model = export_model(seed, device, cfg)
    grey = grey_images(seed + 8, warmup + images, H, W)
    items = [(f"smoke_{i:06d}", g.astype(np.float32) / 255.0) for i, g in enumerate(grey)]
    marks = []

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    with tempfile.TemporaryDirectory() as tmp:
        export_pseudo_labels(model, items[:warmup], Path(tmp) / "warmup", seed=seed + 1,
                             host_warp=False, **kw)
        torch.cuda.synchronize()
        tiles_before = cuda_warp.global_tile_count(device)
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        paths = export_pseudo_labels(model, items[warmup:], tmp, seed=seed, on_phase=on_phase,
                                     host_warp=False, **kw)
        end = time.perf_counter()
        launches = dict(_build.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        global_tiles = cuda_warp.global_tile_count(device) - tiles_before
        files = [np.load(p)["pts"] for p in paths]

    starts = [t for name, _, t in marks if name == "start"] + [end]
    image_s = [b - a for a, b in zip(starts, starts[1:])]
    split = {name: [] for name in EXPORT_PHASES}
    for (_, a, _), (name, b, _) in zip(marks, marks[1:]):
        if name != "start":
            split[name].append(a.elapsed_time(b))
    if launches != {"K4": 3 * images, "nms_tile_keys": images}:
        raise AssertionError(f"{phase}: launches {launches}, want {3 * images} K4 and "
                             f"{images} nms_tile_keys")
    expected = {"views": 0, "heat_back": 0, "mask_back": 0}
    with torch.inference_mode():
        for i in range(images):
            homs = draw_homographies(image_generator(seed, i, device), N, kw["hom_params"])
            inv = torch.linalg.inv(homs)
            over = {"views": (homs, 3), "heat_back": (inv, 1), "mask_back": (inv, 1)}
            for k, (h, c) in over.items():
                expected[k] += int((cuda_warp.window_bytes(h, (N, H, W, c))
                                    > cuda_warp.WINDOW_BYTES).sum())
    if global_tiles != sum(expected.values()):
        raise AssertionError(f"{phase}: {global_tiles} tiles took the warp's global branch, "
                             f"the windows say {expected}")
    n_pts = [len(f) for f in files]
    for f in files:
        if f.ndim != 2 or f.shape[1] != 3 or not 0 < len(f) <= top_k or not np.isfinite(f).all():
            raise AssertionError(f"{phase}: a file holds pts of shape {f.shape}")
        if f[:, 0].min() < 0 or f[:, 0].max() > W - 1 or f[:, 1].min() < 0 \
                or f[:, 1].max() > H - 1:
            raise AssertionError(f"{phase}: points off the frame")
    tx, ty = cuda_warp.tile_grid(H, W)
    m = cfg["model"]
    label = "-".join(str(v) for v in (m.get("name", "YOLOPointDet"), m.get("version")) if v)
    return {"phase": phase, "model": label,
            "nc": len(cfg.get("names", [])),
            "input": [H, W], "dtype": "f32", "num_homographies": N, "warmup_images": warmup,
            "timed_images": images, "s_per_image_p50": statistics.median(image_s),
            "s_per_image_all": image_s,
            "split_ms_p50": {k: statistics.median(v) for k, v in split.items()},
            "peak_memory_gb": peak / 1e9, "launches": launches,
            "global_tiles": {"per_warp": expected, "counter": global_tiles,
                             "tiles_per_warp": images * N * tx * ty},
            "points_per_image": n_pts}, launches


@torch.inference_mode()
def export_reference(seed: int, device: str = "cuda"):
    """One seeded 128x128 image, N = 4 views of the export's parameters
    (drawn once on the CPU), the export's f32 model (TF32 off): the
    aggregate heatmap on the card (K4 warps) against the CPU (plain warps)
    within 1e-5 (the forwards differ in f32 rounding, the matrix inverses in
    the last bits, and the warps back are bilinear); then the keypoints
    decoded from the card's aggregate, on the card (K1) and on the CPU,
    equal. (Random weights put the aggregate near 1/65, by the 0.015
    threshold, so keypoints of two separately computed aggregates are not
    compared.)"""
    from yolopoint_tpu_torch.export import aggregate_heatmap, draw_homographies
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.ops.keypoints import extract_keypoints

    H = W = 128
    kw = export_kwargs(num_homographies=4)
    homs = draw_homographies(torch.Generator().manual_seed(seed + 9), kw["num_homographies"],
                             kw["hom_params"])
    img = torch.from_numpy(grey_images(seed + 10, 1, H, W)[0]).float() / 255.0
    _build.launch_counts.clear()
    agg_g = aggregate_heatmap(export_model(seed, device), img.to(device), homs.to(device),
                              kw["erosion_radius"])
    agg_c = aggregate_heatmap(export_model(seed, "cpu"), img, homs, kw["erosion_radius"])
    err = float((agg_g.cpu() - agg_c).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"export_reference: aggregates differ by {err} > 1e-5")
    args = (kw["conf_thresh"], kw["nms_radius"], kw["top_k"])
    kp_g = extract_keypoints(agg_g[None], *args)
    kp_c = extract_keypoints(agg_g.cpu()[None], *args)
    launches = dict(_build.launch_counts)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(kp_g, kp_c)) or not kp_c[2].any():
        raise AssertionError("export_reference: keypoints of the same aggregate differ or are none")
    if launches.get("nms_tile_keys", 0) != 1 or launches.get("K4", 0) + launches.get("K5", 0) != 3:
        raise AssertionError(f"export_reference: launches {launches}")
    return {"phase": "export_reference", "model": "YOLOPoint-s", "input": [H, W],
            "num_homographies": kw["num_homographies"], "dtype": "f32",
            "aggregate_max_abs": err, "aggregate_max": float(agg_c.max()),
            "keypoints": int(kp_c[2].sum()), "launches_card": launches}


# KITTI frames (375x1242) after `_resize_full` at img_size 960: 290x960,
# padded to 320x960; COCO's 640x480 at img_size 640: 480x640
EXPORT_SIZES = {"kitti": (320, 960), "coco": (480, 640)}


def export_family(seed: int, name: str, images: int = 3, device: str = "cuda"):
    """`export` at the settings of `export_config(name)` (`kitti`:
    SuperPointNet, N = 10; `coco`: YOLOPointDet-S, N = 100, top_k 1000; f32,
    BN unfolded) on 1 warm-up and `images` seeded grey images of
    `EXPORT_SIZES[name]`. For `kitti` also the card against the CPU on one
    image: the aggregate heatmap (the same homographies, drawn on the CPU)
    within 1e-5, and the keypoints of the card's aggregate on the card (K1)
    and on the CPU, equal."""
    from yolopoint_tpu_torch.export import aggregate_heatmap, draw_homographies
    from yolopoint_tpu_torch.ops.keypoints import extract_keypoints

    cfg = export_config(name)
    H, W = EXPORT_SIZES[name]
    line, launches = export(seed, 1, images, device, cfg=cfg, size=(H, W),
                            phase=f"export_{name}")
    if name == "kitti":
        with torch.inference_mode():
            kw = export_kwargs(cfg=cfg)
            homs = draw_homographies(torch.Generator().manual_seed(seed + 14),
                                     kw["num_homographies"], kw["hom_params"])
            img = torch.from_numpy(grey_images(seed + 15, 1, H, W)[0]).float() / 255.0
            agg_g = aggregate_heatmap(export_model(seed, device, cfg), img.to(device),
                                      homs.to(device), kw["erosion_radius"])
            agg_c = aggregate_heatmap(export_model(seed, "cpu", cfg), img, homs,
                                      kw["erosion_radius"])
            err = float((agg_g.cpu() - agg_c).abs().max())
            if not err <= 1e-5:
                raise AssertionError(f"export_kitti: aggregates differ by {err} > 1e-5")
            args = (kw["conf_thresh"], kw["nms_radius"], kw["top_k"])
            kp_g = extract_keypoints(agg_g[None], *args)
            kp_c = extract_keypoints(agg_g.cpu()[None], *args)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(kp_g, kp_c)) \
                    or not kp_c[2].any():
                raise AssertionError("export_kitti: keypoints of one aggregate differ or are none")
        line["card_vs_cpu"] = {"aggregate_max_abs": err, "keypoints": int(kp_c[2].sum())}
    return line, launches


EXPORT_CLI_IMAGES = 8  # of the 1024 of configs/synthetic_export.yaml


def export_cli(seed: int, device: str = "cuda"):
    """`python -m yolopoint_tpu_torch.export.cli` (run in this process as
    `python -m` runs it) on `configs/synthetic_export.yaml` written back by
    the port's `save_config` with only the depth cut (`EXPORT_CLI_IMAGES`
    train images), with a seeded reference-schema weights file of its model
    (YOLOPoint-n, nc=5), on the card. Checks one `.npz` an image, named as
    the dataset names them, holding only `pts` (K <= top_k, 3) inside the
    frame, and 3 warp launches (K5 at its 256x320) and 1 K1 launch an
    image."""
    import runpy

    from yolopoint_tpu_torch.ops import _build, cuda_warp
    from yolopoint_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(REPO / "configs" / "synthetic_export.yaml")
    cfg["data"]["length"]["train"] = EXPORT_CLI_IMAGES
    H, W = cfg["data"]["preprocessing"]["resize"]
    top_k = cfg["model"]["superpoint"]["top_k"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_config(cfg, tmp / "export.yaml")
        save_reference_weights(tmp / "weights.pt", seed, cfg["model"]["version"], cfg["names"])
        argv = ["--config", str(tmp / "export.yaml"), "--weights", str(tmp / "weights.pt"),
                "--output", str(tmp / "points"), "--seed", str(seed)]
        if device != "cuda":
            argv += ["--device", device]
        old_argv = sys.argv
        sys.argv = ["yolopoint_tpu_torch.export.cli", *argv]
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(sys.stderr):
                runpy.run_module("yolopoint_tpu_torch.export.cli", run_name="__main__")
        finally:
            sys.argv = old_argv
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        files = sorted((tmp / "points").iterdir())
        contents = [np.load(f) for f in files]
        keys = [sorted(c.files) for c in contents]
        pts = [c["pts"] for c in contents]
    n = EXPORT_CLI_IMAGES
    names = [f"synth_train_{i:06d}.npz" for i in range(n)]
    if [f.name for f in files] != names or any(k != ["pts"] for k in keys):
        raise AssertionError(f"export_cli: files {[f.name for f in files]}, keys {keys}")
    for p in pts:
        if p.ndim != 2 or p.shape[1] != 3 or not 0 < len(p) <= top_k or not np.isfinite(p).all():
            raise AssertionError(f"export_cli: a file holds pts of shape {p.shape}")
        if p[:, 0].min() < 0 or p[:, 0].max() > W - 1 or p[:, 1].min() < 0 \
                or p[:, 1].max() > H - 1:
            raise AssertionError("export_cli: points off the frame")
    # at 256x320 the JAX package runs the resident warp, K5
    warp = "K5" if cuda_warp.warp_fits_pallas((cfg["export"]["num_homographies"], H, W, 3)) \
        else "K4"
    if launches != {warp: 3 * n, "nms_tile_keys": n}:
        raise AssertionError(f"export_cli: launches {launches}, want {3 * n} {warp} and {n} K1")
    m = cfg["model"]
    return {"phase": "export_cli", "config": "configs/synthetic_export.yaml",
            "model": f"{m['name']}-{m['version']}", "input": [H, W],
            "num_homographies": cfg["export"]["num_homographies"], "images": n,
            "wall_s": wall, "s_per_image": wall / n, "points_per_image": [len(p) for p in pts],
            "launches": launches}, launches


# ---------------------------------------------------------------- the KITTI image-file path

KITTI_FRAMES = {"train": 32, "val": 8}  # PNG files of 375x1242 written at run time
KITTI_NAMES_DONTCARE = 7  # the index of DontCare in configs/kitti.yaml's names
KITTI_VIEW = (288, 896)   # configs/kitti.yaml cropHW
# K1-K4 launch on the fine-tune; K5 does not: the descriptor loss's cell
# mask is (16, 36, 112, 1), and 36 rows fit no row block of the JAX gate
# (`cuda_warp.warp_fits_pallas`), which sends it to the windowed K4
KITTI_KERNELS = ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors", "K4")


def kitti_frame(rng: np.random.Generator, H: int = 375, W: int = 1242) -> np.ndarray:
    """A seeded RGB uint8 street-sized frame: a smooth colour field from a
    coarse grid, rectangles of flat colour, mild noise."""
    coarse = rng.integers(20, 236, (H // 25 + 2, W // 25 + 2, 3)).astype(np.float32)
    img = np.repeat(np.repeat(coarse, 25, 0), 25, 1)[:H, :W]
    for _ in range(30):
        y0, x0 = rng.integers(0, H - 20), rng.integers(0, W - 20)
        h, w = rng.integers(10, H // 3), rng.integers(10, W // 5)
        img[y0:y0 + h, x0:x0 + w] = rng.integers(0, 256, 3)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


def write_kitti_tree(root: Path, seed: int) -> dict:
    """A KITTI-layout tree under `root/kitti`: `KITTI_FRAMES` RGB PNG files
    of 375x1242 (`encode_png`, rows filtered by each of the five types in
    turn), YOLO label files of 3-12 boxes over the 8 names of
    `configs/kitti.yaml` (DontCare included), and `points/<split>/*.npz`
    of 300-600 keypoints `[x, y, prob]` in the frame's pixels. Returns the
    seconds it took and the bytes written."""
    rng = np.random.default_rng(seed)
    t0, n_bytes = time.perf_counter(), 0
    for split, n in KITTI_FRAMES.items():
        for d in ("images", "labels", "points"):
            (root / "kitti" / d / split).mkdir(parents=True)
        for i in range(n):
            name = f"{split}_{i:06d}"
            data = encode_png(kitti_frame(rng)[..., ::-1], 2)  # RGB in the file
            (root / "kitti" / "images" / split / f"{name}.png").write_bytes(data)
            n_bytes += len(data)
            m = int(rng.integers(3, 13))
            boxes = np.concatenate([rng.integers(0, 8, (m, 1)), rng.uniform(0.15, 0.85, (m, 2)),
                                    rng.uniform(0.03, 0.25, (m, 2))], 1)
            boxes[0, 0] = KITTI_NAMES_DONTCARE  # every frame has a DontCare row
            (root / "kitti" / "labels" / split / f"{name}.txt").write_text("".join(
                f"{int(b[0])} {b[1]:.6f} {b[2]:.6f} {b[3]:.6f} {b[4]:.6f}\n" for b in boxes))
            k = int(rng.integers(300, 601))
            pts = np.stack([rng.uniform(0, 1241, k), rng.uniform(0, 374, k),
                            rng.uniform(0.015, 1, k)], 1).astype(np.float32)
            np.savez(root / "kitti" / "points" / split / f"{name}.npz", pts=pts)
    return {"write_s": time.perf_counter() - t0, "png_bytes": n_bytes}


def png_phase(seed: int) -> dict:
    """The compiled host code against its numpy twins, bit for bit: the
    unfilter on images of every colour type and bit depth with every filter
    type, libpng's gamma-corrected grey of 16-bit RGB (its 16-bit tables, at
    two gammas, with and without an sBIT; the time of one 375x1242 frame),
    and the datasets' resize (area and bilinear) of a KITTI frame; the
    decode time of one 375x1242 RGB PNG (inflate, compiled unfilter) against
    the numpy unfilter's, and the compiled resize's against numpy's."""
    import zlib

    from yolopoint_tpu_torch.data import native, png

    rng = np.random.default_rng(seed)
    checked = 0
    for color, depths in png.DEPTHS.items():
        for depth in depths:
            s = rng.integers(0, 2 ** depth, (23, 37, png.CHANNELS[color]))
            pal = rng.integers(0, 256, (2 ** depth, 3)) if color == 3 else None
            for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
                data = encode_png(s, color, depth, filters, palette=pal)
                ihdr, _, idat = png.parse_chunks(data)
                stride, bpp = png.geometry(ihdr)
                raw = np.frombuffer(zlib.decompress(idat), np.uint8)
                if not np.array_equal(png.unfilter_compiled(raw, 23, stride, bpp),
                                      png.unfilter_numpy(raw, 23, stride, bpp)):
                    raise AssertionError(f"png: compiled unfilter differs, colour {color} "
                                         f"depth {depth} filters {filters}")
                if not np.array_equal(png.decode_png(data), png.decode_png(data, device="cpu")):
                    raise AssertionError(f"png: decode differs, colour {color} depth {depth}")
                checked += 1
    # libpng's gamma-corrected grey of 16-bit RGB (the 16-bit tables)
    rgb16 = rng.integers(0, 65536, (375, 1242, 3)).astype(np.uint16)
    rgb16[:100] = rgb16[:100, :, :1]  # grey pixels: the 16-to-8 table
    grey16 = {}
    for gamma, sig_bit in ((45455, 0), (220000, 12)):
        got = native.png_rgb_to_grey_compiled(rgb16, 16, gamma, sig_bit)
        if not np.array_equal(got, native.png_rgb_to_grey(rgb16, 16, gamma, sig_bit)):
            raise AssertionError(f"png: the compiled 16-bit gamma grey differs (gamma {gamma})")
    t0 = time.perf_counter()
    native.png_rgb_to_grey_compiled(rgb16, 16, 45455)
    grey16["compiled_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    native.png_rgb_to_grey(rgb16, 16, 45455)
    grey16["numpy_ms"] = (time.perf_counter() - t0) * 1e3
    frame = kitti_frame(rng)
    data = encode_png(frame[..., ::-1], 2)
    ihdr, _, idat = png.parse_chunks(data)
    stride, bpp = png.geometry(ihdr)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)

    def best_of(fn, n=5):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times), statistics.median(times), out

    decode_ms = best_of(lambda: png.decode_png(data))
    if not np.array_equal(decode_ms[2], frame):
        raise AssertionError("png: the 375x1242 frame does not decode to what was written")
    inflate_ms = best_of(lambda: zlib.decompress(idat))
    unfilter_ms = best_of(lambda: png.unfilter_compiled(raw, 375, stride, bpp))
    unfilter_numpy_ms = best_of(lambda: png.unfilter_numpy(raw, 375, stride, bpp), 1)
    resize = {}
    for mode, (dh, dw) in (("area", (290, 960)), ("bilinear", (500, 1656))):
        c = best_of(lambda: native.resize_u8_compiled(frame, dh, dw, mode))
        n = best_of(lambda: native.resize_u8(frame, dh, dw, mode), 1)
        if not np.array_equal(c[2], n[2]):
            raise AssertionError(f"png: the compiled {mode} resize differs from numpy's")
        resize[mode] = {"to": [dh, dw], "compiled_ms_p50": c[1], "numpy_ms": n[1]}
    return {"phase": "png", "images_checked": checked, "frame": [375, 1242, 3],
            "file_bytes": len(data), "decode_ms_min": decode_ms[0], "decode_ms_p50": decode_ms[1],
            "inflate_ms_p50": inflate_ms[1], "unfilter_compiled_ms_p50": unfilter_ms[1],
            "unfilter_numpy_ms": unfilter_numpy_ms[1], "resize": resize,
            "grey_16bit_gamma_375x1242": grey16}


def kitti_train_config() -> dict:
    """`configs/kitti.yaml`, read by the port's config reader."""
    from yolopoint_tpu_torch.utils.config import load_config

    return load_config(REPO / "configs" / "kitti.yaml")


def views_reference(seed: int, root: Path, device: str = "cuda") -> dict:
    """`build_training_views` under `configs/kitti.yaml`'s augmentation on
    two batches of the written KITTI tree (`Kitti` at the config's 960 px:
    B = 2 in crop mode, (320, 960) frames at random corners, and B = 2 in
    mosaic mode, (576, 1792) canvases at the centre crop), on the card
    against the CPU with the same batch and draws: images within 1e-5;
    label maps, valid masks, point and box masks equal. Also reports how
    far the two devices' inverse homographies are apart (the views' 3x3
    algebra runs in f64, `ops.geometry.mat3_product`, so they agree)."""
    from yolopoint_tpu_torch.data.augmentation import build_training_views, draw_training_views
    from yolopoint_tpu_torch.data.datasets import build_dataset
    from yolopoint_tpu_torch.data.loader import pad_collate

    cfg = kitti_train_config()
    cfg["data"]["labels"]["points"] = str(root / "kitti" / "points")
    aug = cfg["data"]["augmentation"]
    ds = build_dataset(cfg["data"], "train", cfg["names"], root=str(root), device=device)
    out = {"phase": "views_reference"}
    for mode in ("crop", "mosaic"):
        mosaic = mode == "mosaic"
        rng = np.random.RandomState(seed)
        batch = pad_collate([ds.get(i, mosaic=mosaic, rng=rng) for i in range(2)])
        crop = torch.from_numpy(batch["mosaic_crop_yx" if mosaic else "crop_yx"])
        batch = {k: torch.from_numpy(np.asarray(batch[k])) for k in
                 ("image", "points", "point_mask", "boxes", "box_mask")}
        B, H, W, _ = batch["image"].shape
        gen = torch.Generator().manual_seed(seed + mosaic)
        draws = draw_training_views(gen, (B, H, W, 3), aug, crop=True, mosaic=mosaic)
        views = {}
        for dev in ("cpu", device):
            b = _to(batch, dev)
            views[dev] = build_training_views(b["image"], b["points"], b["point_mask"],
                                              b["boxes"], b["box_mask"], aug, _to(draws, dev),
                                              crop_yx=crop.to(dev), mosaic=mosaic)
        want = KITTI_VIEW if not mosaic else (H // 2, W // 2)
        if tuple(views["cpu"][0].image.shape[1:3]) != want:
            raise AssertionError(f"views_reference {mode}: views of {views['cpu'][0].image.shape}")
        line = {"frame": [B, H, W, 3]}
        for name, g, c in zip(("base", "warped"), views[device], views["cpu"]):
            err = float((g.image.cpu() - c.image).abs().max())
            equal = [torch.equal(a.cpu(), b) for a, b in (
                (g.labels_2d, c.labels_2d), (g.valid_mask, c.valid_mask),
                (g.point_mask, c.point_mask), (g.box_mask, c.box_mask))]
            inv_err = float((g.inv_homography.cpu() - c.inv_homography).abs().max())
            if not err <= 1e-5 or not all(equal):
                raise AssertionError(f"views_reference {mode} {name}: image error {err}, "
                                     f"labels/valid/point/box masks equal {equal}, inverse "
                                     f"homographies {inv_err} apart")
            line[name] = {"view": list(c.image.shape), "image_max_abs": err,
                          "inv_homography_max_abs": inv_err,
                          "valid_pixels": int(c.valid_mask.sum()),
                          "labels": int(c.labels_2d.sum()), "boxes": int(c.box_mask.sum())}
        out[mode] = line
    return out


@contextlib.contextmanager
def kitti_probes():
    """Timers and checks around the KITTI training entry while the CLI runs:
    every `_imread` (PNG decode seconds, in the loader's threads) and every
    dataset `get` (seconds a sample, the decode, resize, crop or mosaic
    included), every micro-step (`TrainAgent.step`, host clock to a
    synchronize; plain and mosaic batches apart after the first, which also
    tunes cuDNN; its losses kept, and the batch's boxes checked for
    DontCare), every val batch, the K2 inputs of the first validation, and
    the validation plots (`val_plots`: each panel and each `write_plots`,
    host seconds). Yields the lists."""
    from yolopoint_tpu_torch.data import datasets
    from yolopoint_tpu_torch.ops import nms as nms_module
    from yolopoint_tpu_torch.training import TrainAgent
    from yolopoint_tpu_torch.training import agent as agent_module

    rec = {"decode_s": [], "get_s": [], "step_ms": {"plain": [], "mosaic": []}, "steps": [],
           "wait_ms": [], "last_end": None,
           "step_losses": [], "val_batch_ms": [], "dontcare_boxes": 0, "tiles": [],
           "record_tiles": True, "panel_s": [], "write_plots_s": []}
    real = {"imread": datasets._imread, "get": datasets.ImagePointBoxDataset.get,
            "step": TrainAgent.step, "validate": TrainAgent.validate,
            "nms": nms_module.greedy_nms_keep, "panel": agent_module.plot_val_panel,
            "write_plots": TrainAgent.write_plots}

    def panel(*args, **kwargs):
        t0 = time.perf_counter()
        real["panel"](*args, **kwargs)
        rec["panel_s"].append(time.perf_counter() - t0)

    def write_plots(self, directory, epoch):
        t0 = time.perf_counter()
        real["write_plots"](self, directory, epoch)
        rec["write_plots_s"].append(time.perf_counter() - t0)

    def imread(path, device="cuda", channels=3):
        t0 = time.perf_counter()
        out = real["imread"](path, device, channels)
        rec["decode_s"].append(time.perf_counter() - t0)
        return out

    def get(self, idx, mosaic=None, rng=None):
        t0 = time.perf_counter()
        out = real["get"](self, idx, mosaic, rng)
        rec["get_s"].append(time.perf_counter() - t0)
        return out

    def step(self, batch, on_phase=None):
        kind = "mosaic" if "mosaic_crop_yx" in batch else "plain"
        rec["dontcare_boxes"] += int((batch["boxes"][batch["box_mask"]][:, 0]
                                      == KITTI_NAMES_DONTCARE).sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rec["last_end"] is not None:  # the main thread waiting for the loader
            rec["wait_ms"].append((t0 - rec["last_end"]) * 1e3)
        aux = real["step"](self, batch, on_phase)
        torch.cuda.synchronize()
        rec["last_end"] = time.perf_counter()
        ms = (rec["last_end"] - t0) * 1e3
        if rec["steps"]:  # the run's first micro-step also tunes cuDNN: kept apart
            rec["step_ms"][kind].append(ms)
        rec["steps"].append((kind, ms))
        rec["step_losses"].append({k: float(aux[k]) for k in LOSS_TERMS})
        return aux

    def validate(self, epoch=0, on_phase=None):
        marks = [time.perf_counter()]

        def mark(name):
            if name == "host":
                marks.append(time.perf_counter())

        out = real["validate"](self, epoch, mark)
        rec["val_batch_ms"] += [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        rec["record_tiles"], rec["last_end"] = False, None
        return out

    def nms(boxes, valid, iou_thres):
        if rec["record_tiles"]:
            rec["tiles"].append((boxes.clone(), valid.clone(), float(iou_thres)))
        return real["nms"](boxes, valid, iou_thres)

    datasets._imread = imread
    datasets.ImagePointBoxDataset.get = get
    TrainAgent.step, TrainAgent.validate = step, validate
    nms_module.greedy_nms_keep = nms
    agent_module.plot_val_panel, TrainAgent.write_plots = panel, write_plots
    try:
        yield rec
    finally:
        datasets._imread = real["imread"]
        datasets.ImagePointBoxDataset.get = real["get"]
        TrainAgent.step, TrainAgent.validate = real["step"], real["validate"]
        nms_module.greedy_nms_keep = real["nms"]
        agent_module.plot_val_panel = real["panel"]
        TrainAgent.write_plots = real["write_plots"]


def kitti_seed(first: int, epochs: int) -> int:
    """The first seed from `first` on whose train loader draws both a mosaic
    and a plain batch in `epochs` epochs (the port's `DataLoader` schedule:
    a permutation, then one mosaic draw a batch, each epoch)."""
    cfg = kitti_train_config()
    n, B = KITTI_FRAMES["train"], cfg["training_params"]["train_batch_size"]
    p = cfg["data"]["augmentation"]["mosaic"]
    for seed in range(first, first + 100):
        rng = np.random.default_rng(seed)
        flags = []
        for _ in range(epochs):
            rng.permutation(n)
            flags += list(rng.random(n // B) < p)
        if any(flags) and not all(flags):
            return seed
    raise AssertionError("kitti_seed: no seed in 100 draws both batch kinds")


def fit_kitti(seed: int, root: Path, device: str = "cuda"):
    """The KITTI fine-tune from the CLI: `training.cli` on `configs/kitti.yaml`
    as published (YOLOPoint-S, 8 names with DontCare, bf16, B=16 with accum
    4, 960 px resize, 288x896 device crop, mosaic 0.5, photometric, flips,
    EMA, `freeze_layers: '0-62'`, shrink-perturb, `val_plots: true`) on
    the tree of `write_kitti_tree`, with only: 2 epochs; `pretrained` a
    seeded nc=80 YOLOPoint-S reference-schema file; `labels.points` the
    tree's points; a seed whose loader draws both batch kinds
    (`kitti_seed`). Reports the PNG decode and dataset seconds, ms a
    micro-step plain and mosaic, ms a val batch, the host seconds of the
    validation plots, peak memory and the launches; checks finite losses
    and val scalars, the frozen tensors unchanged tensor by tensor, no
    DontCare box in any batch, both batch kinds, each validation's panels
    and confusion matrix written, and K1-K4 launched (`KITTI_KERNELS`). Returns the line, the
    launches, the run directory, the config path and the K2 inputs of the
    first validation."""
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.training import cli
    from yolopoint_tpu_torch.utils.config import save_config

    cfg = kitti_train_config()
    epochs = 2
    cfg["training_params"]["epochs"] = epochs
    cfg["data"]["augmentation"]["host_warp"] = False  # the device warp path (K4)
    cfg["data"]["labels"]["points"] = str(root / "kitti" / "points")
    if cfg.get("val_plots") is not True:
        raise AssertionError(f"fit_kitti: kitti.yaml has val_plots {cfg.get('val_plots')}")
    weights = root / "yolopoint_s_nc80.pt"
    save_reference_weights(weights, seed, version="s", names=[f"c{i}" for i in range(80)])
    cfg["pretrained"] = str(weights)
    save_config(cfg, root / "kitti.yaml")
    run_seed = kitti_seed(seed, epochs)
    argv = ["--config", str(root / "kitti.yaml"), "--exper_name", "kitti", "--output_dir",
            str(root / "logs"), "--data_root", str(root), "--seed", str(run_seed),
            "--device", device]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    with kitti_probes() as rec:
        t0 = time.perf_counter()
        agent = cli.build_agent(argv)
        build_s = time.perf_counter() - t0
        opt = agent.optimizer
        frozen = {n: p.detach().clone() for n, p, t in zip(opt.names, opt.params, opt.trainable)
                  if not t}
        agent.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    run = root / "logs" / "kitti"
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    val = [{k[len("validation/"):]: v for k, v in r.items() if k.startswith("validation/")}
           for r in records if "validation/fitness" in r]
    params = dict(zip(opt.names, opt.params))
    moved = [n for n, t in frozen.items() if not torch.equal(t, params[n])]
    bad = [k for h in rec["step_losses"] + val for k, x in h.items()
           if isinstance(x, float) and not math.isfinite(x)]
    n_steps = len(rec["step_losses"])
    if n_steps != epochs * (KITTI_FRAMES["train"] // agent.train_loader.batch_size) \
            or len(val) != epochs or bad:
        raise AssertionError(f"fit_kitti: {n_steps} micro-steps, {len(val)} validations, "
                             f"non-finite {bad}")
    if not frozen or moved:
        raise AssertionError(f"fit_kitti: {len(frozen)} frozen tensors, moved {moved[:4]}")
    if rec["dontcare_boxes"]:
        raise AssertionError(f"fit_kitti: {rec['dontcare_boxes']} DontCare boxes reached a batch")
    if {k for k, _ in rec["steps"]} != {"plain", "mosaic"}:
        raise AssertionError(f"fit_kitti: micro-steps {rec['steps']}: not both batch kinds")
    if not (run / "best.pt").exists():
        raise AssertionError("fit_kitti: no best.pt")
    for k in KITTI_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"fit_kitti: kernel {k} was not launched on the KITTI entry")
    plots = sorted(p.name for p in (run / "plots").iterdir())
    missing = [f"e{e}_{n}.png" for e in range(epochs) for n in ("confusion", "panel0")
               if f"e{e}_{n}.png" not in plots]
    if missing or len(rec["write_plots_s"]) != epochs:
        raise AssertionError(f"fit_kitti: plots {plots}, missing {missing}, "
                             f"{len(rec['write_plots_s'])} write_plots calls")
    n_batches = n_steps + len(rec["val_batch_ms"])
    return {
        "phase": "fit_kitti", "config": "configs/kitti.yaml", "model": "YOLOPoint-s",
        "nc": len(cfg["names"]), "batch": cfg["training_params"]["train_batch_size"],
        "accum": agent.accum, "dtype": "bf16", "seed": run_seed, "epochs": epochs,
        "overrides": {"training_params.epochs": epochs, "pretrained": "seeded nc=80 file",
                      "labels.points": "the written tree"},
        "val_plots": {"files": plots, "panel_s": rec["panel_s"],
                      "write_plots_s": rec["write_plots_s"],
                      "host_s_per_val_epoch": (sum(rec["panel_s"]) + sum(rec["write_plots_s"]))
                      / epochs},
        "frames": KITTI_FRAMES, "frozen_tensors": len(frozen),
        "warm_start": {"loaded": len(agent.pretrained_report["loaded"]),
                       "shape_mismatch": len(agent.pretrained_report["shape_mismatch"])},
        "decode_ms_per_image_p50": statistics.median(rec["decode_s"]) * 1e3,
        "images_decoded": len(rec["decode_s"]),
        "get_ms_per_sample_p50": statistics.median(rec["get_s"]) * 1e3,
        # the loader's threads' seconds in `get` (decode, resize, crop, mosaic)
        "dataset_thread_s_per_batch": sum(rec["get_s"]) / n_batches,
        "loader_wait_ms": rec["wait_ms"],
        "steps_in_order": rec["steps"],  # (kind, ms); the 4th applies the update
        "ms_per_step": {k: v for k, v in rec["step_ms"].items()},
        "ms_per_step_p50": {k: statistics.median(v) if v else None
                            for k, v in rec["step_ms"].items()},
        "ms_per_val_batch": rec["val_batch_ms"], "build_agent_s": build_s, "wall_s": wall,
        "peak_memory_gb": peak / 1e9, "val_scalars": val,
        "train_loss": [h["loss"] for h in rec["step_losses"]], "launches": launches,
    }, launches, run, root / "kitti.yaml", rec["tiles"]


def detect_kitti(run: Path, config: Path, root: Path, device: str = "cuda"):
    """`evaluation.detect_cli.main` on the tree's val split with the KITTI
    run's `best.pt` (YOLOPoint-S, nc=8, f32, conf 0.001, batch 16): finite
    metrics over the 8 images and K2 launched. Returns the line, the
    launches and the K2 inputs."""
    from yolopoint_tpu_torch.evaluation import detect_cli
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.ops import nms as nms_module

    tiles, real = [], nms_module.greedy_nms_keep

    def recording(boxes, valid, iou_thres):
        tiles.append((boxes.clone(), valid.clone(), float(iou_thres)))
        return real(boxes, valid, iou_thres)

    argv = ["--config", str(config), "--weights", str(run / "best.pt"), "--data-root",
            str(root), "--out", str(root / "detect.json"), "--device", device]
    _build.launch_counts.clear()
    nms_module.greedy_nms_keep = recording
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = detect_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        nms_module.greedy_nms_keep = real
    launches = dict(_build.launch_counts)
    keys = ("precision", "recall", "mAP50", "mAP", "fitness_yolo")
    if res["images"] != KITTI_FRAMES["val"] or not all(math.isfinite(res[k]) for k in keys):
        raise AssertionError(f"detect_kitti: {res['images']} images, metrics "
                             f"{({k: res[k] for k in keys})}")
    if launches.get("greedy_nms_keep", 0) <= 0:
        raise AssertionError(f"detect_kitti: K2 was not launched ({launches})")
    return {"phase": "detect_kitti", "weights": "fit_kitti best.pt", "images": res["images"],
            **{k: res[k] for k in keys}, "speed_ms_per_image": res["speed_ms_per_image"],
            "wall_s": wall, "ms_per_image": wall * 1e3 / res["images"],
            "k2_launches": len(tiles), "launches": launches}, launches, tiles


def export_kitti_cli(seed: int, root: Path, device: str = "cuda"):
    """`python -m yolopoint_tpu_torch.export.cli` on `configs/kitti_export.yaml`
    (SuperPointNet, N = 10, 960 px) over the tree's train PNG files, with a
    seeded SuperPointNet file for `--weights`: one `.npz` an image, named by
    the image, holding only `pts`; 3 K4 and 1 K1 launches an image."""
    import runpy

    from yolopoint_tpu_torch.models import build_model, state_dict_to_reference
    from yolopoint_tpu_torch.ops import _build

    model = build_model("SuperPointNet", None, device="cpu")
    weights = root / "superpoint.pt"
    torch.save({"model_state_dict": state_dict_to_reference(random_weights(model, seed)),
                "model_name": "SuperPointNet"}, weights)
    argv = ["--config", str(REPO / "configs" / "kitti_export.yaml"), "--weights", str(weights),
            "--data_root", str(root), "--output", str(root / "points_out"), "--seed", str(seed)]
    if device != "cuda":
        argv += ["--device", device]
    old_argv = sys.argv
    sys.argv = ["yolopoint_tpu_torch.export.cli", *argv]
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            runpy.run_module("yolopoint_tpu_torch.export.cli", run_name="__main__")
        torch.cuda.synchronize()
    finally:
        sys.argv = old_argv
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    n = KITTI_FRAMES["train"]
    files = sorted((root / "points_out").iterdir())
    names = [f"train_{i:06d}.npz" for i in range(n)]
    contents = [np.load(f) for f in files]
    if [f.name for f in files] != names or any(sorted(c.files) != ["pts"] for c in contents):
        raise AssertionError(f"export_kitti_cli: files {[f.name for f in files][:4]}...")
    pts = [c["pts"] for c in contents]
    if any(p.ndim != 2 or p.shape[1] != 3 or not len(p) or not np.isfinite(p).all()
           for p in pts):
        raise AssertionError("export_kitti_cli: a file holds no finite (K, 3) points")
    if launches != {"K4": 3 * n, "nms_tile_keys": n}:
        raise AssertionError(f"export_kitti_cli: launches {launches}, want {3 * n} K4, {n} K1")
    return {"phase": "export_kitti_cli", "config": "configs/kitti_export.yaml",
            "model": "SuperPointNet", "images": n, "input": [320, 960], "wall_s": wall,
            "s_per_image": wall / n, "points_per_image": [len(p) for p in pts],
            "launches": launches}, launches


# ---------------------------------------------------------------- JPEG and COCO

COCO_FRAMES = {"train": 64, "val": 16}  # JPEG files of 480x640 written at run time
COCO_SIZE = (480, 640)
COCO_EXPORT_IMAGES = 8
COCO_QUALITY = 95
# the seeded COCO weights' Detect objectness and class biases, raised above
# their priors: at the priors no candidate of the seeded nc = 80 model
# passes the val protocol's conf 0.001, and K2 would see only empty tiles
COCO_DETECT_BIAS = 2.5
JPEG_PSNR_DB = 25.0  # decoded against encoded (q90-95; sharp edges, chroma subsampled)
CONCAT_STEPS = 4
TRAIN_KERNELS = ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors")


def smooth_frame(rng: np.random.Generator, H: int, W: int) -> np.ndarray:
    """A seeded RGB uint8 frame of smooth colour: a coarse random grid (one
    node every 8 pixels) bilinearly interpolated."""
    coarse = rng.uniform(20, 235, (H // 8 + 2, W // 8 + 2, 3))
    ys, xs = np.arange(H) / 8.0, np.arange(W) / 8.0
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = coarse[y0][:, x0] * (1 - fx) + coarse[y0][:, x0 + 1] * fx
    bot = coarse[y0 + 1][:, x0] * (1 - fx) + coarse[y0 + 1][:, x0 + 1] * fx
    return np.round(top * (1 - fy) + bot * fy).astype(np.uint8)


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


UNDO_ORIENTATION = {1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 8, 7: 7, 8: 6}


def jpeg_phase(seed: int) -> dict:
    """The compiled JPEG decoder (`yp_jpeg_decode`) bit-equal to its numpy
    twin on `encode_jpeg` files of every sampling layout and grey at odd
    sizes, every EXIF orientation, restart intervals 1 and 3, one 480x640
    4:2:0 q95 frame, and four-component files (YCCK at 4:2:0 and 4:4:4,
    CMYK with and without an Adobe segment, a 480x640 YCCK frame), these in
    grey too; each decode within `JPEG_PSNR_DB` of what was encoded (the
    orientation undone; for CMYK, OpenCV's BGR of the encoded samples).
    Then the arithmetic-coded and lossless files of `jpeg_kind_cases` in
    colour and in grey (the compiled decoder bit-equal to numpy, both
    refusing the lossless colour read), each SOF9 file of an image within
    `JPEG_PSNR_DB` of it and each lossless file equal to its samples, and
    the same 480x640 q95 4:2:0 frame arithmetic-coded (SOF9), its green
    channel lossless (predictor 1) and the frame lossless in RGB. The
    frames' decode times, compiled (p50 of 7) against numpy."""
    from yolopoint_tpu_torch.data import jpeg

    rng = np.random.default_rng(seed)
    cases = []
    for sampling in (*JPEG_SAMPLING, "grey"):
        for H, W in ((37, 53), (15, 17), (1, 1), (136, 104)):
            img = smooth_frame(rng, H, W)
            src = img[..., 0] if sampling == "grey" else img
            cases.append((f"{sampling}_{H}x{W}", src,
                          encode_jpeg(src, 90, "420" if sampling == "grey" else sampling)))
    img = smooth_frame(rng, 37, 53)
    for o in range(1, 9):
        cases.append((f"orientation_{o}", img, encode_jpeg(img, 90, "420", 0, o)))
    img = smooth_frame(rng, 100, 120)
    for r in (1, 3):
        cases.append((f"restart_{r}", img, encode_jpeg(img, 90, "422", r)))
    frame = kitti_frame(rng, *COCO_SIZE)
    data = encode_jpeg(frame, COCO_QUALITY, "420")
    cases.append(("frame_480x640_q95", frame, data))
    # four components: YCCK (Adobe transform 2), CMYK under transform 0 and
    # with no Adobe segment; held in grey too
    cmyk = np.concatenate([smooth_frame(rng, 37, 53), smooth_frame(rng, 37, 53)[..., :1]], 2)
    for adobe, sampling in ((2, "420"), (2, "444"), (0, "444"), (None, "444")):
        cases.append((f"cmyk_adobe_{adobe}_{sampling}", cmyk,
                      encode_jpeg(cmyk, 90, sampling, 0 if adobe is None else 2, adobe=adobe)))
    cmyk_frame = np.concatenate([frame, frame[..., 1:2]], 2)
    cmyk_data = encode_jpeg(cmyk_frame, COCO_QUALITY, "420", adobe=2)
    cases.append(("ycck_frame_480x640_q95", cmyk_frame, cmyk_data))
    worst = math.inf
    for name, src, blob in cases:
        got = jpeg.decode_jpeg(blob, name)
        want = jpeg.decode_jpeg(blob, name, device="cpu")
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"jpeg: the compiled decoder differs from numpy's on {name}")
        if src.ndim == 3 and src.shape[2] == 4:
            grey = jpeg.decode_jpeg(blob, name, grey=True)
            if not np.array_equal(grey, jpeg.decode_jpeg(blob, name, device="cpu", grey=True)):
                raise AssertionError(f"jpeg: the compiled grey read differs from numpy's on {name}")
            # what OpenCV makes of the CMYK samples that were encoded
            src = np.stack(jpeg.cmyk_bgr(np.moveaxis(src, 2, 0), jpeg.CMYK), 2).astype(np.uint8)
        o = int(name.split("_")[1]) if name.startswith("orientation_") else 1
        ref = np.repeat(src[..., None], 3, axis=2) if src.ndim == 2 else src
        db = psnr_db(jpeg.orient(got, UNDO_ORIENTATION[o]), ref)
        if not db > JPEG_PSNR_DB:
            raise AssertionError(f"jpeg: {name} decodes {db:.1f} dB from what was encoded")
        worst = min(worst, db)

    kinds = jpeg_kind_cases(seed)
    for name, blob, src in kinds:
        for grey in (False, True):
            try:
                want = jpeg.decode_jpeg(blob, name, device="cpu", grey=grey)
            except ValueError:  # a lossless file's colour read: None in cv2 too
                try:
                    jpeg.decode_jpeg(blob, name, grey=grey)
                except ValueError:
                    continue
                raise AssertionError(f"jpeg: the compiled decoder reads {name}, numpy refuses it")
            got = jpeg.decode_jpeg(blob, name, grey=grey)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"jpeg: the compiled decoder differs from numpy's on {name} "
                                     f"({'grey' if grey else 'colour'})")
            hdr = jpeg.parse_header(blob)
            if src is None or grey or hdr.lossless:  # lossless: checked against its samples
                continue
            ref = np.repeat(src[..., None], 3, axis=2) if src.ndim == 2 else src
            db = psnr_db(got, ref)
            if not db > JPEG_PSNR_DB:
                raise AssertionError(f"jpeg: {name} decodes {db:.1f} dB from what was encoded")
            worst = min(worst, db)
        if src is not None and jpeg.parse_header(blob).lossless:
            al = jpeg.parse_header(blob).scans[0].al
            if not np.array_equal(jpeg.decode_jpeg(blob, name, grey=src.ndim == 2),
                                  (src >> al) << al):
                raise AssertionError(f"jpeg: {name} does not decode to its samples")
    arith_data = encode_jpeg(frame, COCO_QUALITY, "420", arithmetic=True)
    lossless_src = frame[..., 1].copy()
    lossless_data = encode_lossless(lossless_src, 1)
    lossless_rgb = encode_lossless(frame, 1)
    arith = jpeg.decode_jpeg(arith_data)
    if not np.array_equal(arith, jpeg.decode_jpeg(arith_data, device="cpu")) \
            or not np.array_equal(arith, jpeg.decode_jpeg(data)):
        raise AssertionError("jpeg: the arithmetic-coded frame differs from numpy's decode or "
                             "from the Huffman-coded frame's")
    if not np.array_equal(jpeg.decode_jpeg(lossless_data, grey=True), lossless_src) \
            or not np.array_equal(jpeg.decode_jpeg(lossless_rgb), frame):
        raise AssertionError("jpeg: a lossless frame does not decode to its samples")

    def times(fn, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    compiled = times(lambda: jpeg.decode_jpeg(data), 7)
    numpy_ms = times(lambda: jpeg.decode_jpeg(data, device="cpu"), 1)
    parse = times(lambda: jpeg.parse_header(data), 7)
    ycck = times(lambda: jpeg.decode_jpeg(cmyk_data), 7)
    ycck_numpy = times(lambda: jpeg.decode_jpeg(cmyk_data, device="cpu"), 1)
    arith_ms = times(lambda: jpeg.decode_jpeg(arith_data), 7)
    arith_numpy = times(lambda: jpeg.decode_jpeg(arith_data, device="cpu"), 1)
    lossless_ms = times(lambda: jpeg.decode_jpeg(lossless_data, grey=True), 7)
    lossless_numpy = times(lambda: jpeg.decode_jpeg(lossless_data, device="cpu", grey=True), 1)
    rgb_ms = times(lambda: jpeg.decode_jpeg(lossless_rgb), 7)
    return {"phase": "jpeg", "files_checked": len(cases), "min_psnr_db": worst,
            "frame": [*COCO_SIZE, 3], "quality": COCO_QUALITY, "sampling": "420",
            "file_bytes": len(data), "frame_psnr_db": psnr_db(jpeg.decode_jpeg(data), frame),
            "decode_ms_p50": statistics.median(compiled), "decode_ms_min": min(compiled),
            "parse_ms_p50": statistics.median(parse), "numpy_decode_ms": numpy_ms[0],
            "ycck_frame": {"file_bytes": len(cmyk_data),
                           "decode_ms_p50": statistics.median(ycck),
                           "numpy_decode_ms": ycck_numpy[0]},
            "kind_files_checked": len(kinds),
            "arith_frame": {"coding": "SOF9", "file_bytes": len(arith_data),
                            "decode_ms_p50": statistics.median(arith_ms),
                            "decode_ms_min": min(arith_ms), "numpy_decode_ms": arith_numpy[0]},
            "lossless_frame": {"coding": "SOF3", "predictor": 1, "frame": list(COCO_SIZE),
                               "file_bytes": len(lossless_data),
                               "decode_ms_p50": statistics.median(lossless_ms),
                               "decode_ms_min": min(lossless_ms),
                               "numpy_decode_ms": lossless_numpy[0],
                               "rgb": {"file_bytes": len(lossless_rgb),
                                       "decode_ms_p50": statistics.median(rgb_ms)}}}


def image_format_files(seed: int, H: int, W: int) -> dict[str, bytes]:
    """Files of the six formats slice 22 reads, of a seeded `(H, W)` frame,
    by this module's writers: TIFF (RGB uncompressed, LZW with the
    predictor in 8-row strips, Deflate in 16x16 tiles, big-endian BigTIFF
    PackBits, 16-bit LZW, unassociated alpha, 16-bit min-is-white in tiles,
    bilevel, 8- and 4-bit palettes, CMYK in separate planes, YCbCr 2x2 LZW
    and 4x4 tiles, JPEG strips and tiles), GIF (a global table; interlaced,
    local, transparent, on a larger screen; clear codes at code size 8), Sun
    raster (1, 8 with a map, 24, 32 bits), PAM (RGB, 16-bit grey, black and
    white), PFM (three channels both byte orders, one channel) and Radiance
    (run-length and flat)."""
    rng = np.random.default_rng(seed)
    img = smooth_frame(rng, H, W)
    rgb = img[..., ::-1]
    green = img[..., 1:2]
    wide = rgb.astype(np.int64) * 257 + rng.integers(0, 257, rgb.shape)
    rgba = np.concatenate([rgb, rng.integers(0, 256, (H, W, 1))], 2)
    cmap16 = rng.integers(0, 65536, (256, 3))
    index = (img[..., 1] >> 4).astype(np.uint8) * 16 + (img[..., 2] >> 4)
    palette = np.stack([np.arange(256) % 16 * 17, np.arange(256) // 16 * 17,
                        np.full(256, 128)], 1).astype(np.uint8)
    values = img.astype(np.float32) / 255 * rng.uniform(0.5, 1.5, img.shape).astype(np.float32)
    return {
        "tiff_rgb.tif": encode_tiff(rgb, 2),
        "tiff_lzw_predictor.tif": encode_tiff(rgb, 2, compression=5, predictor=2,
                                              rows_per_strip=8),
        "tiff_deflate_tiles.tif": encode_tiff(rgb, 2, compression=8, tile=(16, 16)),
        "tiff_packbits_bigtiff_mm.tif": encode_tiff(rgb, 2, compression=32773, order=">",
                                                    big=True, rows_per_strip=5),
        "tiff_rgb16_lzw.tif": encode_tiff(wide, 2, bits=16, compression=5, rows_per_strip=16),
        "tiff_rgba_unassociated.tif": encode_tiff(rgba, 2, extra=(2,), compression=8),
        "tiff_grey16_white_tiles.tif": encode_tiff(wide[..., 1:2], 0, bits=16, tile=(16, 32),
                                                   compression=8),
        "tiff_bilevel.tif": encode_tiff(green > 127, 1, bits=1, compression=32773),
        "tiff_palette8.tif": encode_tiff(index[..., None], 3, colormap=cmap16, compression=5),
        "tiff_palette4.tif": encode_tiff(green >> 4, 3, bits=4, colormap=cmap16[:16] >> 8),
        "tiff_cmyk_planes.tif": encode_tiff(np.concatenate([255 - rgb, green], 2), 5, planar=2,
                                            compression=32773),
        "tiff_ycbcr22_lzw.tif": encode_tiff(rgb, 6, subsampling=(2, 2), compression=5,
                                            rows_per_strip=6),
        "tiff_ycbcr44_tiles.tif": encode_tiff(rgb, 6, subsampling=(4, 4), tile=(32, 16)),
        "tiff_jpeg_strips.tif": encode_tiff(rgb, 6, compression=7, subsampling=(2, 2),
                                            rows_per_strip=16),
        "tiff_jpeg_tiles.tif": encode_tiff(rgb, 6, compression=7, subsampling=(2, 2),
                                           tile=(32, 32)),
        "gif.gif": encode_gif(index, palette),
        "gif_interlaced_local.gif": encode_gif(index[:, :W - 3] >> 4, palette[::16].copy(),
                                               screen=(W, H + 2), offset=(3, 1), local=True,
                                               interlace=True, transparent=2, background=5),
        "gif_clear_codes.gif": encode_gif(index, palette, min_size=8, clear_every=97),
        "sunras_1.ras": encode_sunras(img, 1),
        "sunras_8_map.ras": encode_sunras(img, 8, colormap=True),
        "sunras_24.ras": encode_sunras(img, 24),
        "sunras_32_old.ras": encode_sunras(img, 32, kind=0),
        "pam_rgb.pam": encode_pam(img, "RGB"),
        "pam_grey16.pam": encode_pam(img, "GRAYSCALE", 65535),
        "pam_bw.pam": encode_pam(img, "BLACKANDWHITE"),
        "pfm_le.pfm": encode_pfm(img),
        "pfm_be_scaled.pfm": encode_pfm(img, 2.0),
        "pfm_grey.pfm": encode_pfm(img, -1.0, grey=True),
        "radiance_rle.hdr": encode_radiance(values),
        "radiance_flat.hdr": encode_radiance(values, rle=False),
    }


IMAGE_FORMAT_FRAMES = ("tiff_lzw_predictor.tif", "tiff_packbits_bigtiff_mm.tif",
                       "tiff_jpeg_strips.tif", "gif.gif", "radiance_rle.hdr", "sunras_24.ras",
                       "pam_rgb.pam", "pfm_le.pfm")


def image_formats_phase(seed: int) -> dict:
    """The readers of slice 22 on the card's path (compiled host code:
    `yp_tiff_lzw`, `yp_packbits`, `yp_jpeg_decode`, `yp_gif_lzw`,
    `yp_hdr_rgbe`, the grey conversions) bit-equal to their numpy twins on
    every file of `image_format_files` (37x53), in colour and in grey, both
    refusing the reads OpenCV refuses; then one 480x640 frame of each kind
    of `IMAGE_FORMAT_FRAMES`, its decode compiled (p50 of 7) against numpy
    (one run), beside the Huffman JPEG frame's in the same process."""
    from yolopoint_tpu_torch.data import gif, jpeg, pam, pfm, radiance, sunras, tiff
    from yolopoint_tpu_torch.data.errors import Unreadable

    decoders = {".tif": tiff.decode_tiff, ".gif": gif.decode_gif, ".ras": sunras.decode_sunras,
                ".pam": pam.decode_pam, ".pfm": pfm.decode_pfm,
                ".hdr": radiance.decode_radiance}

    def decoder(name: str):
        return decoders[Path(name).suffix]

    def read(decode, data, name, device, grey):
        try:
            return decode(data, name, device, grey)
        except Unreadable:
            return None

    files = image_format_files(seed, 37, 53)
    checked = 0
    for name, data in files.items():
        for grey in (False, True):
            want = read(decoder(name), data, name, "cpu", grey)
            got = read(decoder(name), data, name, "cuda", grey)
            if (want is None) != (got is None) or (
                    want is not None and (got.shape != want.shape or not np.array_equal(got, want))):
                raise AssertionError(f"image_formats: the compiled read of {name} "
                                     f"({'grey' if grey else 'colour'}) differs from numpy's")
            checked += want is not None

    def times(fn, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    frames = image_format_files(seed + 1, *COCO_SIZE)
    frame_ms = {}
    for name in IMAGE_FORMAT_FRAMES:
        data, decode = frames[name], decoder(name)
        compiled = times(lambda: decode(data, name, "cuda"), 7)
        numpy_ms = times(lambda: decode(data, name, "cpu"), 1)
        if not np.array_equal(decode(data, name, "cuda"), decode(data, name, "cpu")):
            raise AssertionError(f"image_formats: the compiled read of the {name} frame "
                                 "differs from numpy's")
        frame_ms[name] = {"file_bytes": len(data), "decode_ms_p50": statistics.median(compiled),
                          "decode_ms_min": min(compiled), "numpy_decode_ms": numpy_ms[0]}
    frame = kitti_frame(np.random.default_rng(seed), *COCO_SIZE)
    huffman = encode_jpeg(frame, COCO_QUALITY, "420")
    yardstick = times(lambda: jpeg.decode_jpeg(huffman), 7)
    return {"phase": "image_formats", "files": len(files), "reads_checked": checked,
            "frame": list(COCO_SIZE), "frames": frame_ms,
            "huffman_jpeg_ms_p50": statistics.median(yardstick)}


def write_coco_tree(root: Path, seed: int) -> dict:
    """A COCO-layout tree under `root/coco`: `COCO_FRAMES` RGB JPEG files of
    480x640 (`encode_jpeg` at q95; 4:2:0, 4:2:2 and 4:4:4 in turn, every
    fourth with a DRI of 4 MCUs, every eighth with an EXIF orientation of 6
    that `cv2.imread` and the port turn to 640x480), YOLO label files of
    2-10 boxes over COCO's 80 classes, and `points/<split>/*.npz` of
    300-600 keypoints `[x, y, prob]` within the frame's shorter side.
    Returns the seconds it took and the bytes written."""
    rng = np.random.default_rng(seed)
    t0, n_bytes = time.perf_counter(), 0
    H, W = COCO_SIZE
    for split, n in COCO_FRAMES.items():
        for d in ("images", "labels", "points"):
            (root / "coco" / d / split).mkdir(parents=True)
        for i in range(n):
            name = f"{split}_{i:012d}"
            data = encode_jpeg(kitti_frame(rng, H, W), COCO_QUALITY, ("420", "422", "444")[i % 3],
                               restart=4 if i % 4 == 1 else 0, orientation=6 if i % 8 == 7 else 0)
            (root / "coco" / "images" / split / f"{name}.jpg").write_bytes(data)
            n_bytes += len(data)
            m = int(rng.integers(2, 11))
            boxes = np.concatenate([rng.integers(0, 80, (m, 1)), rng.uniform(0.15, 0.85, (m, 2)),
                                    rng.uniform(0.03, 0.3, (m, 2))], 1)
            (root / "coco" / "labels" / split / f"{name}.txt").write_text("".join(
                f"{int(b[0])} {b[1]:.6f} {b[2]:.6f} {b[3]:.6f} {b[4]:.6f}\n" for b in boxes))
            k = int(rng.integers(300, 601))
            pts = np.stack([rng.uniform(0, H - 1, k), rng.uniform(0, H - 1, k),
                            rng.uniform(0.015, 1, k)], 1).astype(np.float32)
            np.savez(root / "coco" / "points" / split / f"{name}.npz", pts=pts)
    return {"write_s": time.perf_counter() - t0, "jpeg_bytes": n_bytes}


@contextlib.contextmanager
def no_numpy_decoders():
    """Fail a decode that takes a numpy twin of a sequential decoder (the
    CPU's path) while the card's paths run: on the card JPEG files, TIFF's
    LZW and PackBits strips, GIF's LZW, Radiance's scanlines, BMP's runs and
    video frames (MPEG-4 Part 2 VOPs, MJPEG, the YUV conversions) decode in
    compiled host code."""
    from yolopoint_tpu_torch.data import bmp, gif, jpeg, mjpeg, mpeg4video, radiance, tiff, yuv

    twins = [(jpeg, "decode_numpy"), (tiff, "lzw_numpy"), (tiff, "packbits_numpy"),
             (gif, "lzw_numpy"), (radiance, "rgbe_numpy"), (bmp, "rle_numpy"),
             (mpeg4video, "reconstruct"), (mjpeg, "planes_numpy"), (yuv, "to_bgr_numpy")]
    real = [getattr(m, n) for m, n in twins]

    def refuser(name):
        def refuse(*args, **kwargs):
            raise AssertionError(f"{name} decoded a file on the card's path")
        return refuse

    for m, n in twins:
        setattr(m, n, refuser(f"{m.__name__}.{n}"))
    try:
        yield
    finally:
        for (m, n), fn in zip(twins, real):
            setattr(m, n, fn)


def export_coco_cli(seed: int, root: Path, device: str = "cuda"):
    """`python -m yolopoint_tpu_torch.export.cli` on `configs/coco_export.yaml`
    as published (YOLOPointDet-S, f32, N = 100, 640 px) over the first
    `COCO_EXPORT_IMAGES` train JPEG files of the tree, with a seeded
    YOLOPointDet-S file for `--weights` (the config's `pretrained` is not in
    the repository): one finite `(K, 3)` `.npz` an image, named by the
    image; 3 K4 and 1 K1 launches an image. Reports s an image and the JPEG
    decode ms an image."""
    import runpy

    from yolopoint_tpu_torch.data import datasets
    from yolopoint_tpu_torch.models import build_model, state_dict_to_reference
    from yolopoint_tpu_torch.ops import _build

    n = COCO_EXPORT_IMAGES
    tree = root / "export_tree" / "coco" / "images" / "train"
    tree.mkdir(parents=True)
    names = sorted(p.name for p in (root / "coco" / "images" / "train").iterdir())[:n]
    for name in names:
        shutil.copy(root / "coco" / "images" / "train" / name, tree / name)
    model = build_model("YOLOPointDet", "s", nc=1, device="cpu")
    weights = root / "yolopointdet_s.pt"
    torch.save({"model_state_dict": state_dict_to_reference(random_weights(model, seed)),
                "model_name": "YOLOPointDet"}, weights)
    argv = ["--config", str(REPO / "configs" / "coco_export.yaml"), "--weights", str(weights),
            "--data_root", str(root / "export_tree"), "--output", str(root / "coco_points_out"),
            "--seed", str(seed)]
    if device != "cuda":
        argv += ["--device", device]
    decode_s, real_imread = [], datasets._imread

    def imread(path, device="cuda", channels=3):
        t0 = time.perf_counter()
        out = real_imread(path, device, channels)
        decode_s.append(time.perf_counter() - t0)
        return out

    old_argv = sys.argv
    sys.argv = ["yolopoint_tpu_torch.export.cli", *argv]
    datasets._imread = imread
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            runpy.run_module("yolopoint_tpu_torch.export.cli", run_name="__main__")
        torch.cuda.synchronize()
    finally:
        sys.argv = old_argv
        datasets._imread = real_imread
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    files = sorted((root / "coco_points_out").iterdir())
    if [f.name for f in files] != [nm.replace(".jpg", ".npz") for nm in names]:
        raise AssertionError(f"export_coco_cli: files {[f.name for f in files][:4]}...")
    pts = [np.load(f)["pts"] for f in files]
    if any(p.ndim != 2 or p.shape[1] != 3 or not len(p) or not np.isfinite(p).all()
           for p in pts):
        raise AssertionError("export_coco_cli: a file holds no finite (K, 3) points")
    if launches != {"K4": 3 * n, "nms_tile_keys": n}:
        raise AssertionError(f"export_coco_cli: launches {launches}, want {3 * n} K4, {n} K1")
    return {"phase": "export_coco_cli", "config": "configs/coco_export.yaml",
            "model": "YOLOPointDet-s", "num_homographies": 100, "images": n,
            "frame": list(COCO_SIZE), "wall_s": wall, "s_per_image": wall / n,
            "decode_ms_per_image": [x * 1e3 for x in decode_s],
            "points_per_image": [len(p) for p in pts], "launches": launches}, launches


def fit_coco(seed: int, root: Path, device: str = "cuda"):
    """COCO joint training from the CLI: `training.cli.main` on
    `configs/coco.yaml` as published (YOLOPoint-S, nc = 80, 640 px
    letterbox, B = 32 with accum to 64, bf16, EMA, photometric and
    homographic augmentation) on the tree of `write_coco_tree`, with only:
    one epoch (2 micro-steps and a validation of 2 batches), `labels.points`
    the tree's, `val_plots` off (the plots are timed in `fit_kitti`; at
    nc = 80 they would add seconds to this phase), `pretrained` a
    seeded nc = 80 file whose Detect biases are raised by `COCO_DETECT_BIAS`
    (so that boxes pass conf 0.001 in the validation). The warp path is
    the CLI's rule (the host on 4 or more cores). Reports ms a micro-step,
    the loader's wait before each, the JPEG decode thread-seconds a batch,
    ms a val batch, peak memory and the logged warp path; checks finite
    losses and val scalars, a checkpoint, K1-K3 launched, and on the host
    path no K4 and one K5 a micro-step (on the device path K4). Returns the
    line, the launches, the run directory, the config path, the K2 inputs of
    the validation and the device warps' inputs (`host_fit_probes`)."""
    import os

    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.training import cli
    from yolopoint_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(REPO / "configs" / "coco.yaml")
    cfg["training_params"]["epochs"] = 1
    cfg["data"]["labels"]["points"] = str(root / "coco" / "points")
    cfg["val_plots"] = False
    weights = root / "yolopoint_s_coco.pt"
    save_reference_weights(weights, seed, version="s", names=cfg["names"],
                           detect_bias=COCO_DETECT_BIAS)
    cfg["pretrained"] = str(weights)
    save_config(cfg, root / "coco.yaml")
    argv = ["--config", str(root / "coco.yaml"), "--exper_name", "coco", "--output_dir",
            str(root / "logs"), "--data_root", str(root), "--seed", str(seed),
            "--device", device]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    with host_fit_probes() as rec:
        t0 = time.perf_counter()
        agent = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    run = root / "logs" / "coco"
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    val = [{k[len("validation/"):]: v for k, v in r.items() if k.startswith("validation/")}
           for r in records if "validation/fitness" in r]
    bad = [k for h in rec["step_losses"] + val for k, x in h.items()
           if isinstance(x, float) and not math.isfinite(x)]
    B = cfg["training_params"]["train_batch_size"]
    if len(rec["step_losses"]) != COCO_FRAMES["train"] // B or len(val) != 1 or bad:
        raise AssertionError(f"fit_coco: {len(rec['step_losses'])} micro-steps, {len(val)} "
                             f"validations, non-finite {bad}")
    host = (os.cpu_count() or 1) >= 4
    form = "numpy" if torch.device(device).type == "cpu" else "compiled"
    want_log = f"augmentation warp path: host ({form})" if host else \
        "augmentation warp path: device (step)"
    if rec["log"] != [want_log]:
        raise AssertionError(f"fit_coco: the CLI logged {rec['log']}, want {want_log}")
    for k in TRAIN_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"fit_coco: kernel {k} was not launched on this path")
    # the host path's one device warp a micro-step: the descriptor loss's cell mask (K5)
    if host and (launches.get("K4", 0) or any(w != {"K4": 0, "K5": 1}
                                              for w in rec["step_warps"])):
        raise AssertionError(f"fit_coco: warp launches {launches.get('K4', 0)} K4 in the run, "
                             f"per micro-step {rec['step_warps']}")
    if not host and launches.get("K4", 0) <= 0:
        raise AssertionError("fit_coco: K4 was not launched on the device path")
    if not (run / "best.pt").exists():
        raise AssertionError("fit_coco: no best.pt")
    n_batches = len(rec["step_ms"]) + len(rec["val_batch_ms"])
    return {
        "phase": "fit_coco", "config": "configs/coco.yaml", "model": "YOLOPoint-s", "nc": 80,
        "input": cfg["data"]["preprocessing"]["img_size"], "batch": B, "accum": agent.accum,
        "dtype": "bf16", "epochs": 1, "frames": COCO_FRAMES, "cpu_count": os.cpu_count(),
        "overrides": {"training_params.epochs": 1, "labels.points": "the written tree",
                      "val_plots": False, "pretrained": "seeded nc=80 file, Detect biases "
                      f"+{COCO_DETECT_BIAS}"},
        "logged_path": rec["log"][0], "loader_threads": agent.train_loader.num_workers,
        "wall_s": wall, "ms_per_step": rec["step_ms"],
        "ms_per_step_p50": statistics.median(rec["step_ms"]), "loader_wait_ms": rec["wait_ms"],
        "decode_ms_per_image_p50": statistics.median(rec["decode_s"]) * 1e3,
        "images_decoded": len(rec["decode_s"]),
        "decode_thread_s_per_batch": sum(rec["decode_s"]) / n_batches,
        "host_warp_thread_s_per_train_batch": [b["thread_s"] for b in rec["batch"]
                                               if b["B"] == B],
        "ms_per_val_batch": rec["val_batch_ms"], "peak_memory_gb": peak / 1e9,
        "val_scalars": val, "warps_per_step": rec["step_warps"],
        "train_loss": [h["loss"] for h in rec["step_losses"]], "launches": launches,
    }, launches, run, root / "coco.yaml", rec["tiles"], list(rec["warps"].values())


def detect_coco(run: Path, config: Path, root: Path, device: str = "cuda"):
    """`evaluation.detect_cli.main` on the COCO tree's val split with
    `fit_coco`'s `best.pt` (YOLOPoint-S, nc = 80, f32, conf 0.001): finite
    metrics (mAP 0 with random weights) over the 16 JPEG files and K2
    launched. Returns the line, the launches and the K2 inputs."""
    from yolopoint_tpu_torch.evaluation import detect_cli
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.ops import nms as nms_module

    tiles, real = [], nms_module.greedy_nms_keep

    def recording(boxes, valid, iou_thres):
        tiles.append((boxes.clone(), valid.clone(), float(iou_thres)))
        return real(boxes, valid, iou_thres)

    argv = ["--config", str(config), "--weights", str(run / "best.pt"), "--data-root",
            str(root), "--out", str(root / "detect_coco.json"), "--device", device]
    _build.launch_counts.clear()
    nms_module.greedy_nms_keep = recording
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = detect_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        nms_module.greedy_nms_keep = real
    launches = dict(_build.launch_counts)
    keys = ("precision", "recall", "mAP50", "mAP", "fitness_yolo")
    if res["images"] != COCO_FRAMES["val"] or not all(math.isfinite(res[k]) for k in keys):
        raise AssertionError(f"detect_coco: {res['images']} images, metrics "
                             f"{({k: res[k] for k in keys})}")
    if launches.get("greedy_nms_keep", 0) <= 0:
        raise AssertionError(f"detect_coco: K2 was not launched ({launches})")
    return {"phase": "detect_coco", "weights": "fit_coco best.pt", "nc": 80,
            "images": res["images"], **{k: res[k] for k in keys},
            "speed_ms_per_image": res["speed_ms_per_image"], "wall_s": wall,
            "ms_per_image": wall * 1e3 / res["images"], "k2_launches": len(tiles),
            "launches": launches}, launches, tiles


def fit_concat(seed: int, root: Path, device: str = "cuda"):
    """The KITTI + COCO mix from the CLI: `training.cli.build_agent` on
    `configs/concat_datasets.yaml` as published (YOLOPoint-S, KITTI's 8
    names, B = 16, bf16, EMA; the sub-configs sampled with length-normalized
    weights), its sub-configs the `kitti.yaml` and `coco.yaml` that
    `fit_kitti` and `fit_coco` wrote beside it (the trees' points, no plots),
    then `CONCAT_STEPS` micro-steps (`train_steps`). KITTI's crop canvas and
    COCO's letterbox differ in shape: a mixed batch is collated on a shared
    canvas. Checks that both datasets were drawn, finite losses and the
    launches; reports ms a micro-step and the loader's wait. Returns the
    line, the launches and the device warps' inputs (`host_fit_probes`: the
    cell mask at each canvas's shape)."""
    import os

    from yolopoint_tpu_torch.data.datasets import ImagePointBoxDataset
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.training import cli
    from yolopoint_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(REPO / "configs" / "concat_datasets.yaml")
    save_config(cfg, root / "concat_datasets.yaml")  # beside root/kitti.yaml, root/coco.yaml
    argv = ["--config", str(root / "concat_datasets.yaml"), "--exper_name", "concat",
            "--output_dir", str(root / "logs"), "--data_root", str(root), "--seed", str(seed),
            "--device", device]
    drawn, real_get, lock = [], ImagePointBoxDataset.get, threading.Lock()

    def get(self, idx, mosaic=None, rng=None):
        out = real_get(self, idx, mosaic, rng)
        with lock:
            drawn.append((type(self).__name__, out["image"].shape[:2]))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    ImagePointBoxDataset.get = get
    try:
        with host_fit_probes() as rec:
            t0 = time.perf_counter()
            agent = cli.build_agent(argv)
            agent.train_steps(CONCAT_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        ImagePointBoxDataset.get = real_get
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    kinds = {k for k, _ in drawn}
    bad = [k for h in rec["step_losses"] for k, x in h.items() if not math.isfinite(x)]
    if len(rec["step_losses"]) != CONCAT_STEPS or bad or kinds != {"Kitti", "Coco"}:
        raise AssertionError(f"fit_concat: {len(rec['step_losses'])} micro-steps, non-finite "
                             f"{bad}, datasets drawn {sorted(kinds)}")
    # on the host path the step's one device warp is the descriptor loss's
    # cell mask: K5, or K4 where its rows fit no row block of the JAX gate
    host = (os.cpu_count() or 1) >= 4
    if host and (any(sum(w.values()) != 1 for w in rec["step_warps"]) or not rec["warps"]):
        raise AssertionError(f"fit_concat: warp launches per micro-step {rec['step_warps']}, "
                             f"inputs recorded {list(rec['warps'])}")
    if not host and launches.get("K4", 0) <= 0:
        raise AssertionError("fit_concat: K4 was not launched on the device path")
    return {
        "phase": "fit_concat", "config": "configs/concat_datasets.yaml", "model": "YOLOPoint-s",
        "nc": len(cfg["names"]), "batch": agent.train_loader.batch_size, "dtype": "bf16",
        "datasets": [type(d).__name__ for d in agent.train_loader.datasets],
        "sizes": agent.train_loader.sizes, "logged_path": rec["log"],
        "samples_drawn": {k: sum(1 for n, _ in drawn if n == k) for k in sorted(kinds)},
        "sample_shapes": sorted({(n, tuple(int(v) for v in hw)) for n, hw in drawn}),
        "steps": CONCAT_STEPS, "wall_s": wall, "ms_per_step": rec["step_ms"],
        "ms_per_step_p50": statistics.median(rec["step_ms"]), "loader_wait_ms": rec["wait_ms"],
        "decode_ms_per_image_p50": statistics.median(rec["decode_s"]) * 1e3,
        "peak_memory_gb": peak / 1e9, "warps_per_step": rec["step_warps"],
        "warp_inputs": [[*shape, mode] for shape, mode in rec["warps"]],
        "train_loss": [h["loss"] for h in rec["step_losses"]], "launches": launches,
    }, launches, list(rec["warps"].values())


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- the host-warp path

# (name, frame (H, W, C), homographies): the s640 frame, a KITTI frame at
# 960 px with crop-conjugated homographies, the KITTI mosaic canvas
HOST_WARP_INPUTS = (("s640", (640, 640, 3), "s640"),
                    ("kitti_crop", (320, 960, 3), "kitti_crop"),
                    ("mosaic_canvas", (576, 1792, 3), "mosaic"))


def host_warp_homographies(kind: str, hw: tuple[int, int], count: int,
                           rng: np.random.Generator) -> list:
    """float64 full-frame homographies as the host path warps by them:
    `s640` draws of configs/synthetic_s640.yaml's H1; `kitti_crop`
    configs/kitti.yaml's H1 drawn in its 288x896 crop frame at a random
    corner and conjugated into the frame; `mosaic` its mosaic H1 conjugated
    from the canvas's centre crop."""
    from yolopoint_tpu_torch.data.host_augment import NORM_SHAPE, compose_crop
    from yolopoint_tpu_torch.ops.homography import sample_homography_np

    H, W = hw
    if kind == "s640":
        params, crop = s640_train_config()["data"]["augmentation"]["homographic"]["params"], None
    else:
        hom = kitti_train_config()["data"]["augmentation"]["homographic"]
        if kind == "mosaic":
            params, (hc, wc), tl = hom["mosaic"]["params"], (H // 2, W // 2), (H // 4, W // 4)
        else:
            params, (hc, wc) = hom["params"], hom["cropHW"]
            tl = (int(rng.integers(0, H - hc + 1)), int(rng.integers(0, W - wc + 1)))
        crop = {"H_crop": hc, "W_crop": wc, "tl": tl, "HW_full": (H, W)}
    params = {k: v for k, v in params.items() if k != "cropHW"}
    out = []
    for _ in range(count):
        h = sample_homography_np(NORM_SHAPE, shift=-1.0, seed=int(rng.integers(2**31)), **params)
        out.append(h if crop is None else compose_crop(h, crop))
    return out


def _timed(fn, *args, reps: int = 1, **kwargs):
    """`(result, median ms over reps)` of a host call."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def host_warp_reference(seed: int) -> dict:
    """The host warp's compiled form (`ops/csrc/host_image.cpp`, built with
    the kernels) against its numpy twin, bit for bit, on this machine's CPU:
    the warp (bilinear and nearest, C = 1 and 3), the warp coverage and the
    erosion (the 6x6 ellipse of `valid_border_margin: 3`) at each of
    `HOST_WARP_INPUTS` under 2 homographies; ms a call of both forms (the
    compiled one the median of 5)."""
    from yolopoint_tpu_torch.data import native
    from yolopoint_tpu_torch.ops.geometry import ellipse_kernel

    rng = np.random.default_rng(seed)
    kernel = ellipse_kernel(3)
    out = {"phase": "host_warp_reference", "inputs": {}}
    for name, (H, W, C), kind in HOST_WARP_INPUTS:
        img = rng.uniform(0, 1, (H, W, C)).astype(np.float32)
        ms = {"numpy": {}, "compiled": {}}
        checked = 0
        for h in host_warp_homographies(kind, (H, W), 2, rng):
            for mode in ("bilinear", "nearest"):
                for c in (1, 3):
                    src = np.ascontiguousarray(img[..., :c])
                    a, t_np = _timed(native.warp_perspective_f32, src, h, mode)
                    b, t_c = _timed(native.warp_perspective_f32_compiled, src, h, mode, reps=5)
                    if not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
                        raise AssertionError(f"host_warp_reference {name} {mode} C={c}: "
                                             f"{int((a != b).sum())} pixels differ")
                    ms["numpy"][f"{mode}_c{c}"], ms["compiled"][f"{mode}_c{c}"] = t_np, t_c
                    checked += 1
            a, t_np = _timed(native.warp_coverage_f32, (H, W), h)
            b, t_c = _timed(native.warp_coverage_f32_compiled, (H, W), h, reps=5)
            mask = a.copy()
            mask[0], mask[-1], mask[:, 0], mask[:, -1] = 0, 0, 0, 0
            e_np, te_np = _timed(native.erode, mask, kernel)
            e_c, te_c = _timed(native.erode_compiled, mask, kernel, reps=5)
            if not (np.array_equal(a, b) and np.array_equal(e_np, e_c)) or not a.any():
                raise AssertionError(f"host_warp_reference {name}: coverage or erosion differs")
            ms["numpy"].update(coverage=t_np, erode=te_np)
            ms["compiled"].update(coverage=t_c, erode=te_c)
            checked += 2
        out["inputs"][name] = {"frame": [H, W, C], "homographies": kind, "checks": checked,
                               "bit_equal": True, "ms_per_call": ms}
    return out


def random_batch(rng: np.random.Generator, B: int, H: int, W: int, n_points: int = 300,
                 n_boxes: int = 12) -> dict:
    """A seeded raw batch as the loader collates it: uint8 images, points,
    boxes (class, normalized centre and size) and their masks."""
    boxes = np.concatenate([rng.integers(0, 5, (B, n_boxes, 1)),
                            rng.uniform(0.3, 0.7, (B, n_boxes, 2)),
                            rng.uniform(0.05, 0.3, (B, n_boxes, 2))], -1).astype(np.float32)
    return {"image": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
            "points": (rng.uniform(0, 1, (B, n_points, 2)) * [W - 1, H - 1]).astype(np.float32),
            "point_mask": np.ones((B, n_points), bool), "boxes": boxes,
            "box_mask": np.ones((B, n_boxes), bool)}


def views_host_reference(seed: int, device: str = "cuda") -> dict:
    """The host-warp views of a GPU run against a CPU run's: `host_warp_views`
    with the compiled warp against the numpy one on the same batch and seed
    (every payload array bit-equal), then `build_training_views(precomputed=
    ...)` on the card against the CPU with the same payload and draws
    (images within 1e-5; label maps, valid, point and box masks equal); in
    plain mode (configs/synthetic_s640.yaml, (2, 640, 640)), crop mode
    (configs/kitti.yaml, (2, 320, 960) frames, 288x896 crops) and mosaic
    mode ((2, 576, 1792) canvases). Reports the payload's seconds in both
    forms, on one thread."""
    from yolopoint_tpu_torch.data.augmentation import build_training_views, draw_training_views
    from yolopoint_tpu_torch.data.host_augment import host_warp_views
    from yolopoint_tpu_torch.training.step import draw_shape, precomputed_views

    rng = np.random.default_rng(seed)
    s640 = s640_train_config()["data"]["augmentation"]
    kitti = kitti_train_config()["data"]["augmentation"]
    out = {"phase": "views_host_reference"}
    for mode, aug, (B, H, W) in (("plain", s640, (2, 640, 640)), ("crop", kitti, (2, 320, 960)),
                                 ("mosaic", kitti, (2, 576, 1792))):
        batch = random_batch(rng, B, H, W)
        if mode == "crop":
            hc, wc = aug["homographic"]["cropHW"]
            batch["crop_yx"] = np.stack([rng.integers(0, H - hc + 1, B),
                                         rng.integers(0, W - wc + 1, B)], -1).astype(np.float32)
        elif mode == "mosaic":
            batch["mosaic_crop_yx"] = np.array([[H // 4, W // 4]] * B, np.float32)
        payload = {}
        seconds = {}
        for dev in ("cpu", device):
            t0 = time.perf_counter()
            payload[dev] = host_warp_views(batch, aug, np.random.default_rng(seed + 3), device=dev)
            seconds["numpy" if dev == "cpu" else "compiled"] = time.perf_counter() - t0
        differ = [k for k in payload["cpu"] if k != "names" and not (
            payload["cpu"][k].dtype == payload[device][k].dtype
            and np.array_equal(payload["cpu"][k], payload[device][k]))]
        if differ:
            raise AssertionError(f"views_host_reference {mode}: payload arrays {differ} differ")
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in payload["cpu"].items()}
        crop_key = next((k for k in ("mosaic_crop_yx", "crop_yx") if k in tb), None)
        gen = torch.Generator().manual_seed(seed + 4)
        draws = draw_training_views(gen, draw_shape(tb), aug, crop=crop_key is not None,
                                    mosaic=mode == "mosaic", precomputed=True)
        views = {}
        for dev in ("cpu", device):
            b = _to(tb, dev)
            views[dev] = build_training_views(
                b["image"], b["points"], b["point_mask"], b["boxes"], b["box_mask"], aug,
                _to(draws, dev), crop_yx=None if crop_key is None else b[crop_key],
                mosaic=mode == "mosaic", precomputed=_to(precomputed_views(tb), dev))
        line = {"frame": [B, H, W, 3], "payload_s": seconds}
        for name, g, c in zip(("base", "warped"), views[device], views["cpu"]):
            err = float((g.image.cpu() - c.image).abs().max())
            equal = [torch.equal(a.cpu(), b) for a, b in (
                (g.labels_2d, c.labels_2d), (g.valid_mask, c.valid_mask),
                (g.point_mask, c.point_mask), (g.box_mask, c.box_mask))]
            if not err <= 1e-5 or not all(equal) or not c.valid_mask.any():
                raise AssertionError(f"views_host_reference {mode} {name}: image error {err}, "
                                     f"labels/valid/point/box masks equal {equal}")
            line[name] = {"view": list(c.image.shape), "image_max_abs": err,
                          "valid_pixels": int(c.valid_mask.sum()),
                          "labels": int(c.labels_2d.sum()), "boxes": int(c.box_mask.sum())}
        out[mode] = line
    return out


@contextlib.contextmanager
def host_fit_probes():
    """Timers around the host-warp training entry while the CLI runs: every
    micro-step (`TrainAgent.step`, host clock to a synchronize; its losses
    and its own K4 and K5 launches), the train loader's wait for each batch
    (the host clock of each `next` on a shuffled `DataLoader`), every
    host-warped batch (`host_warp_views`: its wall and the thread-seconds of
    its images' `one_image` calls), every image file read (`_imread`, in the
    loader's threads), every val batch, the K2 inputs of the first
    validation, the first input of each shape and mode of the device warp
    (`warp_image_cuda`: on the host path the descriptor loss's cell mask),
    and the log line of the warp path. Yields the lists they fill."""
    import logging

    from yolopoint_tpu_torch.data import datasets, host_augment, loader
    from yolopoint_tpu_torch.ops import _build, cuda_warp
    from yolopoint_tpu_torch.ops import nms as nms_module
    from yolopoint_tpu_torch.training import TrainAgent
    from yolopoint_tpu_torch.utils.logging import LOGGER

    rec = {"step_ms": [], "step_losses": [], "step_warps": [], "wait_ms": [], "batch": [],
           "one_image_s": [], "val_batch_ms": [], "log": [], "decode_s": [], "tiles": [],
           "record_tiles": True, "warps": {}}
    real = {(TrainAgent, "step"): TrainAgent.step, (TrainAgent, "validate"): TrainAgent.validate,
            (loader.DataLoader, "__iter__"): loader.DataLoader.__iter__,
            (loader, "host_warp_views"): loader.host_warp_views,
            (host_augment, "one_image"): host_augment.one_image,
            (datasets, "_imread"): datasets._imread,
            (nms_module, "greedy_nms_keep"): nms_module.greedy_nms_keep,
            (cuda_warp, "warp_image_cuda"): cuda_warp.warp_image_cuda}
    lock = threading.Lock()

    def step(self, batch, on_phase=None):
        before = {k: _build.launch_counts.get(k, 0) for k in ("K4", "K5")}
        t0 = time.perf_counter()
        aux = real[(TrainAgent, "step")](self, batch, on_phase)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["step_losses"].append({k: float(aux[k]) for k in LOSS_TERMS})
        rec["step_warps"].append({k: _build.launch_counts.get(k, 0) - n
                                  for k, n in before.items()})
        return aux

    def validate(self, epoch=0, on_phase=None):
        marks = [time.perf_counter()]

        def mark(name):
            if name == "host":
                marks.append(time.perf_counter())

        out = real[(TrainAgent, "validate")](self, epoch, mark)
        rec["val_batch_ms"] += [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        rec["record_tiles"] = False
        return out

    def imread(path, device="cuda", channels=3):
        t0 = time.perf_counter()
        out = real[(datasets, "_imread")](path, device, channels)
        with lock:
            rec["decode_s"].append(time.perf_counter() - t0)
        return out

    def nms(boxes, valid, iou_thres):
        if rec["record_tiles"]:
            rec["tiles"].append((boxes.clone(), valid.clone(), float(iou_thres)))
        return real[(nms_module, "greedy_nms_keep")](boxes, valid, iou_thres)

    def warp(img, homography_inv, mode="bilinear"):
        key = (tuple(img.shape), mode)
        if key not in rec["warps"]:
            rec["warps"][key] = (img.clone(), homography_inv.clone(), mode)
        return real[(cuda_warp, "warp_image_cuda")](img, homography_inv, mode)

    def batches(self):
        it = real[(loader.DataLoader, "__iter__")](self)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            if self.shuffle:
                rec["wait_ms"].append((time.perf_counter() - t0) * 1e3)
            yield b

    def warp_views(batch, *args, **kwargs):
        n0 = len(rec["one_image_s"])
        t0 = time.perf_counter()
        out = real[(loader, "host_warp_views")](batch, *args, **kwargs)
        with lock:
            thread_s = sum(rec["one_image_s"][n0:])
        rec["batch"].append({"B": len(batch["image"]), "wall_s": time.perf_counter() - t0,
                             "thread_s": thread_s})
        return out

    def one_image(*args):
        t0 = time.perf_counter()
        out = real[(host_augment, "one_image")](*args)
        with lock:
            rec["one_image_s"].append(time.perf_counter() - t0)
        return out

    class Capture(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("augmentation warp path:"):
                rec["log"].append(msg)

    wrappers = {"step": step, "validate": validate, "__iter__": batches,
                "host_warp_views": warp_views, "one_image": one_image, "_imread": imread,
                "greedy_nms_keep": nms, "warp_image_cuda": warp}
    handler = Capture()
    LOGGER.addHandler(handler)
    for (owner, name) in real:
        setattr(owner, name, wrappers[name])
    try:
        yield rec
    finally:
        LOGGER.removeHandler(handler)
        for (owner, name), fn in real.items():
            setattr(owner, name, fn)


def fit_host(seed: int, fit_line: dict, device: str = "cuda"):
    """The training entry on the host-warp path: `training.cli.main` on
    `configs/synthetic_s640.yaml` with `FIT_OVERRIDES`' depth cut and no
    `host_warp` key (the CLI's rule picks the host on 4 or more cores; on
    fewer, `host_warp: true` is set and the line says so): YOLOPoint-S,
    nc=5, 640x640, B=32, bf16, accum 2, 2 epochs of 4 micro-steps and 2
    val batches. Reports ms a micro-step, the train loader's wait before
    each, the host warp's wall and thread-seconds a batch, ms a val batch
    and peak memory beside `fit`'s device-path numbers. Checks the logged
    path, finite losses and val scalars, no K4 launch in the whole run and
    exactly one K5 launch (the descriptor loss's cell mask) in each
    micro-step. Returns the line and the path's launches."""
    import os

    from yolopoint_tpu_torch.data.loader import DataLoader
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.training import cli
    from yolopoint_tpu_torch.utils.config import dict_update, save_config

    cores = os.cpu_count() or 1
    cfg = dict_update(s640_train_config(),
                      dict(FIT_OVERRIDES, data={"length": FIT_OVERRIDES["data"]["length"]}))
    forced = cores < 4
    if forced:
        cfg["data"]["augmentation"]["host_warp"] = True
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_config(cfg, tmp / "fit_host.yaml")
        argv = ["--config", str(tmp / "fit_host.yaml"), "--exper_name", "fit_host",
                "--output_dir", str(tmp / "logs"), "--data_root", str(tmp / "data"),
                "--seed", str(seed), "--device", device]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        with host_fit_probes() as rec:
            t0 = time.perf_counter()
            agent = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        records = [json.loads(line) for line in
                   (tmp / "logs" / "fit_host" / "metrics.jsonl").read_text().splitlines()]
    val = [{k[len("validation/"):]: v for k, v in r.items() if k.startswith("validation/")}
           for r in records if "validation/fitness" in r]
    bad = [k for h in rec["step_losses"] + val for k, x in h.items() if not math.isfinite(x)]
    form = "numpy" if torch.device(device).type == "cpu" else "compiled"
    if rec["log"] != [f"augmentation warp path: host ({form})"]:
        raise AssertionError(f"fit_host: the CLI logged {rec['log']}")
    if not isinstance(agent.train_loader, DataLoader) or agent.train_loader.host_augment_config \
            is None or agent.val_loader.host_augment_config is None:
        raise AssertionError("fit_host: the loaders do not warp on the host")
    if len(rec["step_losses"]) != 8 or len(val) != 2 or bad:
        raise AssertionError(f"fit_host: {len(rec['step_losses'])} micro-steps, {len(val)} "
                             f"validations, non-finite {bad}")
    if launches.get("K4", 0) or any(w != {"K4": 0, "K5": 1} for w in rec["step_warps"]):
        raise AssertionError(f"fit_host: warp launches {launches.get('K4', 0)} K4 in the run, "
                             f"per micro-step {rec['step_warps']}")
    for k in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"fit_host: kernel {k} was not launched on this path")
    train_b = [b for b in rec["batch"] if b["B"] == cfg["training_params"]["train_batch_size"]]
    val_b = [b for b in rec["batch"] if b["B"] == cfg["training_params"]["val_batch_size"]]
    return {
        "phase": "fit_host", "model": f"YOLOPoint-{cfg['model']['version']}", "nc": len(cfg["names"]),
        "input": cfg["data"]["preprocessing"]["resize"],
        "batch": cfg["training_params"]["train_batch_size"], "dtype": "bf16",
        "cpu_count": cores, "host_warp_forced": forced, "logged_path": rec["log"][0],
        "loader_threads": agent.train_loader.num_workers, "wall_s": wall,
        "ms_per_step_p50": statistics.median(rec["step_ms"]), "ms_per_step_all": rec["step_ms"],
        "loader_wait_ms_p50": statistics.median(rec["wait_ms"]),
        "loader_wait_ms_all": rec["wait_ms"],
        "host_warp_train_batch": {
            "wall_s_p50": statistics.median(b["wall_s"] for b in train_b),
            "thread_s_p50": statistics.median(b["thread_s"] for b in train_b),
            "batches": len(train_b)},
        "host_warp_val_batch": {
            "wall_s_p50": statistics.median(b["wall_s"] for b in val_b),
            "thread_s_p50": statistics.median(b["thread_s"] for b in val_b),
            "batches": len(val_b)},
        "ms_per_val_batch_p50": statistics.median(rec["val_batch_ms"]),
        "peak_memory_gb": peak / 1e9,
        "device_path": {"fit_ms_per_step_p50": fit_line["ms_per_step_p50"],
                        "fit_ms_per_val_batch_p50": fit_line["ms_per_val_batch_p50"],
                        "fit_peak_memory_gb": fit_line["peak_memory_gb"]},
        "warps_per_step": rec["step_warps"], "train_loss": [h["loss"] for h in rec["step_losses"]],
        "val_scalars": val, "launches": launches,
    }, launches


def export_host(seed: int, warmup: int = 1, images: int = 3, device: str = "cuda"):
    """`export_pseudo_labels(host_warp=True)` at configs/synthetic_s640_export.yaml
    (YOLOPoint-S, nc=5, N = 50 views, 640x640, f32, seeded weights) on
    `warmup` + `images` seeded grey images: the views, masks and warps back
    in compiled host code, the forwards and the keypoint NMS on the card.
    Reports s an image (from the previous image's keypoints to its own) and
    its host split; checks no K4 or K5 launch and one K1 an image, and
    every file's points. Then, on the first timed image: its homographies
    equal to a CPU run's draws from the same seed, and the aggregate of its
    first 4 views on the card (compiled warps) against the CPU (numpy
    warps, the CPU forward) within 1e-5, `export_reference`'s tolerance,
    with the keypoints of the card's aggregate decoded on both equal.
    Returns the line and the timed images' launches."""
    from yolopoint_tpu_torch.export import homography_adaptation as ha
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.ops.keypoints import extract_keypoints

    cfg = s640_export_config()
    H, W = cfg["data"]["preprocessing"]["resize"]
    kw = export_kwargs(cfg=cfg)
    N, top_k = kw["num_homographies"], kw["top_k"]
    model = export_model(seed, device, cfg)
    grey = grey_images(seed + 8, warmup + images, H, W)
    items = [(f"smoke_{i:06d}", g.astype(np.float32) / 255.0) for i, g in enumerate(grey)]
    marks, drawn = [], []
    real_draw = ha.host_homographies

    def record_draw(*args, **kwargs):
        drawn.append(real_draw(*args, **kwargs))
        return drawn[-1]

    def on_phase(name):
        marks.append((name, time.perf_counter()))

    with tempfile.TemporaryDirectory() as tmp:
        ha.export_pseudo_labels(model, items[:warmup], Path(tmp) / "warmup", seed=seed + 1,
                                host_warp=True, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        ha.host_homographies = record_draw
        try:
            t0 = time.perf_counter()
            paths = ha.export_pseudo_labels(model, items[warmup:], tmp, seed=seed,
                                            host_warp=True, on_phase=on_phase, **kw)
        finally:
            ha.host_homographies = real_draw
        launches = dict(_build.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        files = [np.load(p)["pts"] for p in paths]
    ends = [t for name, t in marks if name == "aggregate_nms"]
    image_s = [b - a for a, b in zip([t0] + ends, ends)]
    split = {k: [] for k in ("views", "forward", "warps_back", "aggregate_nms")}
    prev = t0
    for name, t in marks:
        split[name].append((t - prev) * 1e3)
        prev = t
    if launches != {"nms_tile_keys": images}:
        raise AssertionError(f"export_host: launches {launches}, want {images} nms_tile_keys "
                             "and no warp")
    for f in files:
        if f.ndim != 2 or f.shape[1] != 3 or not 0 < len(f) <= top_k or not np.isfinite(f).all():
            raise AssertionError(f"export_host: a file holds pts of shape {f.shape}")

    cpu_draws = ha.host_homographies(np.random.default_rng(seed), N, kw["hom_params"])
    if len(drawn) != images or not np.array_equal(cpu_draws, drawn[0]):
        raise AssertionError("export_host: the card run's homographies differ from the CPU's")
    homs = drawn[0][:4]
    img = items[warmup][1]
    agg_g = ha.aggregate_heatmap_host(model, img, homs, kw["erosion_radius"])
    agg_c = ha.aggregate_heatmap_host(export_model(seed, "cpu", cfg), img, homs,
                                      kw["erosion_radius"])
    err = float(np.abs(agg_g - agg_c).max())
    args = (kw["conf_thresh"], kw["nms_radius"], top_k)
    kp_g = extract_keypoints(torch.from_numpy(agg_g)[None].to(device), *args)
    kp_c = extract_keypoints(torch.from_numpy(agg_g)[None], *args)
    if not err <= 1e-5 or not all(torch.equal(a.cpu(), b) for a, b in zip(kp_g, kp_c)) \
            or not kp_c[2].any():
        raise AssertionError(f"export_host: the aggregates differ by {err}, or the keypoints "
                             "of the card's aggregate differ or are none")
    return {"phase": "export_host", "model": "YOLOPoint-s", "nc": len(cfg.get("names", [])),
            "input": [H, W], "dtype": "f32", "num_homographies": N, "warmup_images": warmup,
            "timed_images": images, "s_per_image_p50": statistics.median(image_s),
            "s_per_image_all": image_s,
            "host_split_ms_p50": {k: statistics.median(v) for k, v in split.items()},
            "peak_memory_gb": peak / 1e9, "launches": launches,
            "points_per_image": [len(f) for f in files],
            "reference": {"views": len(homs), "homographies_equal": True,
                          "aggregate_max_abs": err, "keypoints": int(kp_c[2].sum())}}, launches


# the other families through the training CLI: (name, has a Detect head)
TRAIN_FAMILIES = (("YOLOPointv52", True), ("YOLOPointDet", False), ("YOLOv8Point", True),
                  ("SuperPointNet", False))
FAMILY_OVERRIDES = {  # configs/synthetic_s640.yaml, cut in depth only
    "data": {"length": {"train": 64, "val": 8}},
    "training_params": {"epochs": 1, "val_interval": 1, "save_interval": 1},
}


def fit_families(seed: int, device: str = "cuda"):
    """`training.cli.main` with `--model <family> --version s` on
    `configs/synthetic_s640.yaml` cut to `FAMILY_OVERRIDES` (nc=5, 640x640,
    B=32, bf16, accum 2: 2 micro-steps, one optimizer update, one val batch
    of 8), the warp path by the CLI's rule, for each of `TRAIN_FAMILIES`.
    Reports ms a micro-step (the first includes the warm-up), ms the val
    batch and peak memory per family;
    checks finite losses and val scalars, the parameters moved, and box NMS
    (K2) launched exactly for the families with a Detect head. Returns the
    lines and each family's launches."""
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.training import TrainAgent, cli
    from yolopoint_tpu_torch.utils.config import dict_update, save_config

    out, all_launches = [], {}
    real_step, real_validate = TrainAgent.step, TrainAgent.validate
    for name, detect in TRAIN_FAMILIES:
        cfg = dict_update(s640_train_config(), FAMILY_OVERRIDES)
        steps, val_ms = [], []

        def step(self, batch, on_phase=None):
            t0 = time.perf_counter()
            aux = real_step(self, batch, on_phase)
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3, {k: float(aux[k]) for k in LOSS_TERMS}))
            return aux

        def validate(self, epoch=0, on_phase=None):
            marks = [time.perf_counter()]
            result = real_validate(self, epoch, lambda n: n == "host" and marks.append(
                time.perf_counter()))
            val_ms.extend((b - a) * 1e3 for a, b in zip(marks, marks[1:]))
            return result

        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            save_config(cfg, tmp / "fit.yaml")
            argv = ["--config", str(tmp / "fit.yaml"), "--exper_name", name, "--output_dir",
                    str(tmp / "logs"), "--data_root", str(tmp / "data"), "--seed", str(seed),
                    "--device", device, "--model", name, "--version", "s"]
            agent = cli.build_agent(argv)
            before = {n: p.detach().clone() for n, p in agent.model.named_parameters()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.launch_counts.clear()
            TrainAgent.step, TrainAgent.validate = step, validate
            try:
                t0 = time.perf_counter()
                agent.train()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                TrainAgent.step, TrainAgent.validate = real_step, real_validate
            launches = dict(_build.launch_counts)
            peak = torch.cuda.max_memory_allocated()
            records = [json.loads(line) for line in (tmp / "logs" / name / "metrics.jsonl")
                       .read_text().splitlines()]
        val = [{k[len("validation/"):]: v for k, v in r.items() if k.startswith("validation/")}
               for r in records if "validation/fitness" in r]
        moved = sum(not torch.equal(p.detach(), before[n])
                    for n, p in agent.model.named_parameters())
        losses = [s[1] for s in steps]
        bad = [k for h in losses + val for k, x in h.items() if not math.isfinite(x)]
        if type(agent.model).__name__ != name or len(losses) != 2 or len(val) != 1 or bad \
                or not moved:
            raise AssertionError(f"fit_families {name}: {len(losses)} micro-steps, {len(val)} "
                                 f"validations, non-finite {bad}, {moved} tensors moved")
        if (launches.get("greedy_nms_keep", 0) > 0) != detect:
            raise AssertionError(f"fit_families {name}: {launches.get('greedy_nms_keep', 0)} "
                                 f"box NMS launches with{'' if detect else 'out'} a Detect head")
        for k in ("nms_tile_keys", "sample_descriptors", "K5"):
            if launches.get(k, 0) <= 0:
                raise AssertionError(f"fit_families {name}: kernel {k} was not launched")
        all_launches[name] = launches
        label = name if name == "SuperPointNet" else f"{name}-s"  # it has no versions
        out.append({"phase": "fit_families", "model": label, "nc": len(cfg["names"]),
                    "input": cfg["data"]["preprocessing"]["resize"],
                    "batch": cfg["training_params"]["train_batch_size"], "dtype": "bf16",
                    "host_warp": agent.train_loader.host_augment_config is not None,
                    "detect_head": detect, "wall_s": wall,
                    "ms_per_step_all": [s[0] for s in steps],
                    "ms_per_step_last": steps[-1][0], "ms_per_val_batch": val_ms,
                    "peak_memory_gb": peak / 1e9,
                    "tensors_moved": moved, "train_loss": [h["loss"] for h in losses],
                    "val_scalars": val[0], "launches": launches})
    return out, all_launches


# ---------------------------------------------------------------- data parallelism

DP_TIMEOUT = 600  # seconds a session of worker processes may take, start-up included
DP_STEPS = 3  # timed micro-steps of the two-rank s640 step
MULTI_K = 4  # micro-steps a dispatch in multi_step
DP_SERVE_BATCH = 16
DP_SERVE_SIZE = 640
DP_REFERENCE = dict(B=4, H=128)  # the 2-rank step held card against CPU: B = 2 a rank
SPATIAL_BATCH = 2
SPATIAL_SIZE = 640  # 320 rows a shard on 2 ranks
SPATIAL_REPS = 5
BN_TOLERANCE = dict(atol=1e-5, rtol=1e-5)  # tests/test_torch_dp_step.py's
DETERMINISTIC_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def run_ranks(name: str, world: int, backend: str, device: str, env=None,
              timeout: float = DP_TIMEOUT, logs: list | None = None) -> list:
    """`world` processes of this script in worker mode (`--worker`), one a
    rank, that join one process group (`backend`; ranks past the card count
    share it, which only gloo allows) and run `DP_WORKERS[name]` (a name
    `NAME:ARG` passes `ARG` as its second argument). Returns their results
    in rank order, and appends each rank's output to `logs` where given; a
    failing or late worker fails the phase and every worker is stopped
    (`parallel.launch.run_ranks`)."""
    import os

    from yolopoint_tpu_torch.parallel import launch

    with tempfile.TemporaryDirectory() as tmp:
        done = launch.run_ranks(
            world, lambda r, addr: [sys.executable, str(Path(__file__).resolve()), "--worker",
                                    name, str(r), str(world), addr, backend, device, tmp],
            timeout, env={**os.environ, **(env or {})})
        for r, (code, log) in enumerate(done):
            if code != 0:
                raise AssertionError(f"{name}: rank {r} of {world} failed ({code}):\n"
                                     f"{log[-6000:]}")
        if logs is not None:
            logs.extend(log for _, log in done)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def worker_main(argv) -> int:
    """Worker mode: `--worker NAME[:ARG] RANK WORLD ADDR BACKEND DEVICE OUT`."""
    name, rank, world, addr, backend, device, out = argv
    sys.path.insert(0, str(REPO))
    from yolopoint_tpu_torch import set_determinism
    from yolopoint_tpu_torch.parallel.mesh import initialize_multi_host, shutdown

    set_determinism()
    mesh = initialize_multi_host(addr, int(world), int(rank), device=device, backend=backend)
    name, _, arg = name.partition(":")
    try:
        result = DP_WORKERS[name](mesh, *([arg] if arg else []))
        torch.save(result, Path(out) / f"rank{rank}.pt")
    finally:
        shutdown()
    return 0


def flat_tensors(tree, prefix="") -> dict:
    """Every tensor of a nested dict / list, by path."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_tensors(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_tensors(v, f"{prefix}{i}."))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree
    return out


def differing(a: dict, b: dict) -> list:
    """Paths whose tensors are not bit-equal (or are missing on a side)."""
    fa, fb = flat_tensors(a), flat_tensors(b)
    return sorted(set(fa) ^ set(fb)) + [k for k in fa if k in fb and not torch.equal(fa[k], fb[k])]


def ranks_differ(mesh, tensors: dict) -> list:
    """Names of `tensors` whose values differ from rank 0's (each broadcast
    from rank 0 and compared on every rank)."""
    from yolopoint_tpu_torch.parallel.mesh import broadcast_tensors

    names = sorted(tensors)
    mine = [tensors[n].detach().to(mesh.device) for n in names]
    copies = [t.clone() for t in mine]
    broadcast_tensors(copies, mesh)
    return [n for n, c, t in zip(names, copies, mine) if not torch.equal(c, t)]


def s640_dp_agent(mesh, seed: int = 0, length: int | None = None):
    """A `TrainAgent` on the s640 training config on `mesh`, fed seeded
    global batches of 32 (this rank's rows)."""
    from yolopoint_tpu_torch.training import TrainAgent

    cfg = s640_train_config()
    tp = cfg["training_params"]
    B, (H, W) = tp["train_batch_size"], cfg["data"]["preprocessing"]["resize"]
    loader = SeededBatches(seed + 3, B, H, W, len(cfg["names"]),
                           length or cfg["data"]["length"]["train"], mesh.device)
    run_dir = tempfile.mkdtemp(prefix="yolopoint_run_")
    agent = TrainAgent(cfg, run_dir, loader, seed=seed, device=mesh.device, mesh=mesh)
    weakref.finalize(agent, shutil.rmtree, run_dir, ignore_errors=True)
    return agent, loader


def draws_of(agent, batch) -> dict:
    from yolopoint_tpu_torch.training.step import batch_mode, draw_shape, draw_step

    return draw_step(agent.gen, draw_shape(batch), agent.aug_config, agent.weights,
                     **batch_mode(batch))


def dp_world1_worker(mesh) -> dict:
    """One rank over NCCL, deterministic algorithms: (1) the DP step against
    the step without a mesh, from one saved state on one batch with the same
    draws; (2) one `make_multi_step` dispatch of K = 4 against 4 single
    micro-steps, and one `make_device_multi_step` dispatch on (4, B) rows of
    a resident set against 4 single micro-steps on the same rows, each from
    the saved state: every tensor of the state bit-equal, the scalars
    stacked (4,); (3) `InferencePipeline.sharded` at world size 1."""
    import copy

    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.parallel.mesh import shard_batch
    from yolopoint_tpu_torch.training.checkpoint import load_payload, state_payload
    from yolopoint_tpu_torch.training.step import (make_device_multi_step, make_multi_step,
                                                   make_train_step, stack_batches)

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    agent, loader = s640_dp_agent(mesh)
    saved = copy.deepcopy(state_payload(agent.state))
    gen_state = agent.gen.get_state()
    batches = [shard_batch(b, mesh) for b in loader.batches[:MULTI_K]]

    def restart():
        load_payload(agent.state, saved)
        agent.gen.set_state(gen_state)

    ema = agent.config["training_params"].get("ema") or {}
    plain = make_train_step(agent.model, agent.aug_config, agent.obj_cfg, agent.weights,
                            agent.nc, ema_decay=float(ema.get("decay", 0.9999)),
                            ema_tau=float(ema.get("tau", 2000.0)), accum=agent.accum,
                            compute_dtype=agent.compute_dtype)
    out = {}
    draws = draws_of(agent, batches[0])
    aux_plain = plain(agent.state, batches[0], draws)
    after_plain = copy.deepcopy(state_payload(agent.state))
    restart()
    aux_dp = agent.train_step(agent.state, batches[0], draws_of(agent, batches[0]))
    diff = differing(after_plain, state_payload(agent.state))
    out["dp_vs_plain"] = {"tensors": len(flat_tensors(after_plain)), "differ": diff[:5],
                          "n_differ": len(diff),
                          "aux_equal": all(float(aux_plain[k]) == float(aux_dp[k])
                                           for k in aux_plain)}

    def singles(bs):
        auxes = [agent.train_step(agent.state, b, draws_of(agent, b)) for b in bs]
        return copy.deepcopy(state_payload(agent.state)), auxes

    restart()
    s_state, s_aux = singles(batches)
    restart()
    _build.launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_aux = make_multi_step(agent.train_step, MULTI_K)(
        agent.state, stack_batches(batches), [draws_of(agent, b) for b in batches])
    torch.cuda.synchronize()
    multi_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    diff = differing(s_state, state_payload(agent.state))
    out["multi"] = {"n_differ": len(diff), "differ": diff[:5], "ms_per_micro_step":
                    multi_s * 1e3 / MULTI_K, "aux_shapes": {k: list(v.shape) for k, v in
                                                             m_aux.items()},
                    "aux_equal": all(torch.equal(m_aux[k].cpu(), torch.stack(
                        [torch.as_tensor(a[k], dtype=torch.float32).cpu() for a in s_aux]))
                        for k in m_aux),
                    "launches": launches}

    data = {k: torch.cat([b[k] for b in loader.batches]) for k in loader.batches[0]}
    n = data["image"].shape[0]
    idx = torch.randperm(n, generator=torch.Generator().manual_seed(5))[
        :MULTI_K * batches[0]["image"].shape[0]].reshape(MULTI_K, -1)
    gathered = [{k: v[row.to(v.device)] for k, v in data.items()} for row in idx]
    restart()
    r_state, r_aux = singles(gathered)
    restart()
    _build.launch_counts.clear()
    d_aux = make_device_multi_step(agent.train_step, MULTI_K)(
        agent.state, data, idx, [draws_of(agent, b) for b in gathered])
    torch.cuda.synchronize()
    diff = differing(r_state, state_payload(agent.state))
    out["device_multi"] = {"n_differ": len(diff), "differ": diff[:5], "resident": n,
                           "aux_shapes": {k: list(v.shape) for k, v in d_aux.items()},
                           "aux_equal": all(torch.equal(d_aux[k].cpu(), torch.stack(
                               [torch.as_tensor(a[k], dtype=torch.float32).cpu()
                                for a in r_aux])) for k in d_aux),
                           "launches": dict(_build.launch_counts)}
    out["accum"] = agent.accum
    out["deterministic"] = True
    del agent
    torch.cuda.empty_cache()
    out["serve"], _ = dp_serve(mesh)
    return out


def dp_serve(mesh, batch: int = DP_SERVE_BATCH, reps: int = 1) -> tuple[dict, dict]:
    """`InferencePipeline.sharded()` on a global batch of `batch` uint8
    640x640 images (YOLOPoint-S f32, BN folded, the Detect biases raised by
    `DEMO_DETECT_BIAS` so that boxes pass, the serve operating point at f32
    heatmaps): ms a global batch (median of `reps`, each after a barrier)
    against the one-card pipeline on this rank's card over the same rows at
    the same per-rank batch (each rank's rows in turn) and over all of them
    in one call. Every output equal to the one-card pipeline's but the
    descriptors (within 1e-5), with valid boxes among them. Returns the line
    and the warm-up call's kernel inputs (`kernel_input_probes`)."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.parallel.mesh import barrier

    cfg = dict(SERVE_CONFIG, heatmap_dtype="f32")
    dev = mesh.device
    model = folded_yolopoint_s(0, torch.float32, dev, detect_bias=DEMO_DETECT_BIAS)
    pipe = InferencePipeline(model, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    images = torch.randint(0, 256, (batch, DP_SERVE_SIZE, DP_SERVE_SIZE, 3),
                           generator=gen, device=dev, dtype=torch.uint8)
    fn = pipe.sharded(mesh)
    with kernel_input_probes() as rec:
        fn(images)  # warm-up, its kernel inputs recorded
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    times = []
    for _ in range(reps):
        barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(images)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.launch_counts)
    per = batch // mesh.size

    def one_card():
        parts = [pipe(images[r * per:(r + 1) * per]) for r in range(mesh.size)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    want = one_card()
    torch.cuda.synchronize()
    one_ms = [_timed_ms(lambda: (one_card(), torch.cuda.synchronize())) for _ in range(3)]
    pipe(images)
    torch.cuda.synchronize()
    whole_ms = [_timed_ms(lambda: (pipe(images), torch.cuda.synchronize())) for _ in range(3)]
    exact = {k: torch.equal(got[k], want[k]) for k in want}
    err = {k: float((got[k].float() - want[k].float()).abs().max()) for k in want
           if want[k].is_floating_point()}
    boxes = int(want["box_valid"].sum())
    if not all(v for k, v in exact.items() if k != "descriptors") or \
            err["descriptors"] > 1e-5 or not boxes:
        raise AssertionError(f"sharded_serve: rank {mesh.rank} of {mesh.size} against the "
                             f"one-card pipeline: exact {exact}, errors {err}, {boxes} valid boxes")
    return {"world": mesh.size, "batch": batch, "batch_rank": per,
            "ms_p50": statistics.median(times), "ms_all": times,
            "one_card_ms_p50": statistics.median(one_ms), "one_card_ms_all": one_ms,
            "one_call_ms_p50": statistics.median(whole_ms), "exact": exact,
            "max_abs_err": err, "keypoints_valid": int(want["kp_valid"].sum()),
            "boxes_valid": boxes, "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}, rec


def dp_world2_worker(mesh) -> dict:
    """Two ranks over gloo on one card: (1)-(2) `dp_train`, the rank 0
    inputs of its device warp returned for the parent to check;
    (3) `InferencePipeline.sharded`; (4) `spatial_sharded_forward`; (5) the
    YOLOPoint-n 128 px step that the CPU run repeats (`dp_reference`)."""
    out, warps = dp_train(mesh)
    out["warps"] = list(warps.values())
    torch.cuda.empty_cache()
    out["serve"], _ = dp_serve(mesh)
    out["spatial"] = dp_spatial(mesh)
    out["reference"] = dp_reference(mesh)
    return out


def dp_train(mesh) -> tuple[dict, dict]:
    """The s640 step data-parallel on `mesh`, global B = 32: (1) 1 warm-up
    and `DP_STEPS` timed micro-steps, ms a micro-step, the all-reduce's
    CUDA-event and host time after a barrier (the wait for the slowest rank,
    timed apart), its bytes, peak memory, K4/K5 launches, the ranks' states
    bit-equal; (2) a `make_multi_step` dispatch of `MULTI_K` whose third
    micro-step holds a NaN pixel in the last rank's rows only: skipped on
    every rank, their states still equal. Returns this rank's line and its
    first input to the device warp of each shape and mode in (1)-(2) (the
    dispatch runs the warps at the timed steps' shapes)."""
    from yolopoint_tpu_torch.ops import _build, cuda_warp
    from yolopoint_tpu_torch.parallel.mesh import barrier, shard_batch
    from yolopoint_tpu_torch.training import step as step_module

    agent, loader = s640_dp_agent(mesh)
    batches = iter(loader)
    agent.step(shard_batch(next(batches), mesh))  # warm-up
    real_reduce, real_warp = step_module.all_reduce_mean, cuda_warp.warp_image_cuda
    reduce_ms, reduce_host_ms, wait_ms, reduce_bytes = [], [], [], []
    warps = {}  # (shape, mode) -> this rank's first input of it to the device warp

    def recording_warp(img, homography_inv, mode="bilinear"):
        key = (tuple(img.shape), mode)
        if key not in warps:
            warps[key] = (img.clone(), homography_inv.clone(), mode)
        return real_warp(img, homography_inv, mode)

    def timed_reduce(tensors, m):
        # the wait for the slowest rank (a barrier) apart from the all-reduce
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        barrier(m)
        torch.cuda.synchronize()
        wait_ms.append((time.perf_counter() - t0) * 1e3)
        reduce_bytes.append(sum(t.numel() * t.element_size() for t in tensors))
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        real_reduce(tensors, m)
        b.record()
        torch.cuda.synchronize()
        reduce_host_ms.append((time.perf_counter() - t0) * 1e3)
        reduce_ms.append(a.elapsed_time(b))

    step_module.all_reduce_mean = timed_reduce
    cuda_warp.warp_image_cuda = recording_warp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    step_ms, losses = [], []
    try:
        for _ in range(DP_STEPS):
            t0 = time.perf_counter()
            aux = agent.step(shard_batch(next(batches), mesh))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v) for k, v in aux.items()})
    finally:
        step_module.all_reduce_mean = real_reduce
        cuda_warp.warp_image_cuda = real_warp
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    differ = ranks_differ(mesh, state_tensors(agent))

    from yolopoint_tpu_torch.training.step import make_multi_step, stack_batches

    stacked = stack_batches([{**b, "image": b["image"].float() / 255.0}
                             for b in loader.batches[:MULTI_K]])
    B, H, W = stacked["image"].shape[1:4]
    nan_row = (mesh.size - 1) * (B // mesh.size) + 1  # in the last rank's rows
    stacked["image"][2, nan_row, H // 3, W // 2, 0] = float("nan")  # micro-step 2
    local = shard_batch(stacked, mesh, leading_stack=True)
    draws = [draws_of(agent, {k: v[i] for k, v in local.items()}) for i in range(MULTI_K)]
    nan_aux = make_multi_step(agent.train_step, MULTI_K)(agent.state, local, draws)
    nan_differ = ranks_differ(mesh, state_tensors(agent))
    out = {"world": mesh.size, "backend": mesh.backend, "accum": agent.accum,
           "batch_global": loader.batches[0]["image"].shape[0], "batch_rank": B // mesh.size,
           "ms_per_step": step_ms, "allreduce_event_ms": reduce_ms,
           "allreduce_host_ms": reduce_host_ms, "allreduce_wait_ms": wait_ms,
           "allreduce_bytes": reduce_bytes[-1], "peak_memory_gb": peak / 1e9,
           "launches": launches, "losses": losses, "ranks_differ": differ,
           "tensors": len(state_tensors(agent)),
           "nan_dispatch": {"nonfinite_skip": nan_aux["nonfinite_skip"].tolist(),
                            "ranks_differ": nan_differ, "nan_row": nan_row}}
    return out, warps


def dp_spatial(mesh, data: int = 1, spatial: int | None = None) -> dict:
    """`spatial_sharded_forward` of YOLOPoint-S (f32, seeded random weights,
    BN in eval) on `SPATIAL_BATCH` 640x640 images at the `(data, spatial)`
    layout (`spatial` defaults to the ranks over `data`): the gathered maps'
    largest error against the whole-image forward on this card (within
    1e-4), the forward with and without `gather_spatial` (median of
    `SPATIAL_REPS`, after a barrier each) against the whole-image forward,
    the halo all-gathers a forward makes with their bytes, the same
    all-gathers alone (replayed on the recorded halo rows), and the forward
    with each all-gather replaced by local copies (its maps unused: the
    mode's own cost)."""
    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.parallel import spatial as spatial_module
    from yolopoint_tpu_torch.parallel.mesh import barrier

    model = build_model("YOLOPoint", "s", nc=80, device="cpu")
    model.load_state_dict(random_weights(model, 0))
    model = model.to(mesh.device).eval()
    sp = spatial_module.make_spatial_mesh(mesh, data=data, spatial=spatial)
    gen = torch.Generator(device=mesh.device).manual_seed(9)
    images = torch.rand((SPATIAL_BATCH, 3, SPATIAL_SIZE, SPATIAL_SIZE), generator=gen,
                        device=mesh.device)
    fwd = spatial_module.spatial_sharded_forward(model, sp)
    local = spatial_module.shard_images(images, sp)
    real, gathers = spatial_module.all_gather, []

    def recording(t, m):
        gathers.append(t.clone())
        return real(t, m)

    def local_only(t, m):  # the parts' shapes without the collective
        return [t.clone() for _ in range(m.size)]

    spatial_module.all_gather = recording
    try:
        fwd(local)  # warm-up, its halo all-gathers recorded
    finally:
        spatial_module.all_gather = real

    def timed(fn) -> list:
        times = []
        for _ in range(SPATIAL_REPS):
            barrier(mesh)
            torch.cuda.synchronize()
            times.append(_timed_ms(lambda: (fn(), torch.cuda.synchronize())))
        return times

    full = spatial_module.gather_spatial(fwd(local), sp)
    fwd_ms = timed(lambda: fwd(local))
    ms = timed(lambda: spatial_module.gather_spatial(fwd(local), sp))
    gathers_ms = timed(lambda: [real(t, mesh) for t in gathers])
    spatial_module.all_gather = local_only
    try:
        no_comm_ms = timed(lambda: fwd(local))
    finally:
        spatial_module.all_gather = real
    with torch.no_grad():
        want = model(images)
        whole_ms = timed(lambda: model(images))
    err = {k: float((full[k] - want[k]).abs().max()) for k in ("semi", "desc")}
    err.update({f"objects{i}": float((a - b).abs().max())
                for i, (a, b) in enumerate(zip(full["objects"], want["objects"]))})
    if max(err.values()) > 1e-4:
        raise AssertionError(f"spatial ({sp.data}, {sp.spatial}): rank {mesh.rank} off the whole "
                             f"image by {err}")
    return {"world": mesh.size, "layout": [sp.data, sp.spatial],
            "rows_a_shard": SPATIAL_SIZE // sp.spatial, "batch": SPATIAL_BATCH,
            "max_abs_err": err, "ms_p50": statistics.median(ms),
            "forward_ms_p50": statistics.median(fwd_ms),
            "whole_ms_p50": statistics.median(whole_ms),
            "ratio": statistics.median(ms) / statistics.median(whole_ms),
            "halo_all_gathers": len(gathers),
            "halo_bytes": sum(t.numel() * t.element_size() * mesh.size for t in gathers),
            "halo_all_gathers_alone_ms_p50": statistics.median(gathers_ms),
            "forward_without_collectives_ms_p50": statistics.median(no_comm_ms),
            "semi_shape": list(full["semi"].shape)}


def dp_reference(mesh) -> dict:
    """One DP micro-step of YOLOPoint-n at 128x128 in f32, a global batch of
    4 (2 a rank), the s640 augmentation and flagship losses, from seeded
    weights, batch and per-rank draws made on the CPU: the averaged scalars
    and the norms of the averaged gradient (the accumulator at `accum` 2).
    Run on the card and on the CPU with the same inputs."""
    from yolopoint_tpu_torch.losses import ObjectLossConfig
    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.parallel.mesh import shard_batch
    from yolopoint_tpu_torch.training import (LossWeights, create_train_state, draw_step,
                                              make_optimizer, make_train_step,
                                              rescale_yolo_gains)

    cfg = s640_train_config()
    aug = cfg["data"]["augmentation"]
    sp = cfg["model"]["superpoint"]["sparse_loss"]["params"]
    weights = LossWeights(lambda_desc=0.1, lambda_obj=10.0, desc_loss_type="infonce",
                          det_loss_type="ce", num_samples_per_image=sp["num_samples_per_image"],
                          num_masked_non_matches_per_match=sp["num_masked_non_matches_per_match"])
    nc, B, H = len(cfg["names"]), DP_REFERENCE["B"], DP_REFERENCE["H"]
    obj = rescale_yolo_gains(ObjectLossConfig(**{k: cfg["model"]["yolo"][k]
                                                 for k in ("box", "obj", "cls", "anchor_t")}),
                             nc, H)
    torch.manual_seed(0)
    model = build_model("YOLOPoint", "n", nc=nc, device="cpu").train()
    batch = shard_batch(SeededBatches(1, B, H, H, nc, B, "cpu", distinct=1).batches[0], mesh)
    draws = [draw_step(torch.Generator().manual_seed(2 + r), (B // mesh.size, H, H, 3), aug,
                       weights) for r in range(mesh.size)][mesh.rank]
    dev = mesh.device
    model = model.to(dev)
    opt = make_optimizer(model, learning_rate=1e-3, lrf=0.1, total_epochs=125,
                         steps_per_epoch=32, grad_clip=10.0, accumulate_steps=2)
    state = create_train_state(model, opt, ema=True)
    step = make_train_step(model, aug, obj, weights, nc, accum=2, mesh=mesh)
    aux = step(state, _to(batch, dev), _to(draws, dev))
    return {"losses": {k: float(aux[k]) for k in LOSS_TERMS},
            "grad_norms": {n: float(a.norm()) for n, a in zip(opt.names, opt.acc)},
            "bn": {n: b.detach().cpu() for n, b in model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))}}


DP_WORKERS = {"dp_world1": dp_world1_worker, "dp_world2": dp_world2_worker,
              "dp_reference": dp_reference}


def reference_fields(card: dict, cpu: dict, phase: str) -> dict:
    """`dp_reference` on the card or cards against the CPU ranks: losses
    within 1e-4 relative, gradient norms 1e-3 (`train_reference`'s), the
    BatchNorm statistics within `BN_TOLERANCE`; raises, under `phase`'s
    name, outside them."""
    loss_rel = {k: abs(card["losses"][k] - v) / max(abs(v), 1e-12)
                for k, v in cpu["losses"].items()}
    grad_rel = {n: abs(card["grad_norms"][n] - v) / max(v, 1e-12)
                for n, v in cpu["grad_norms"].items() if v > 0}
    worst = max(grad_rel, key=grad_rel.get)
    bn_err = max(float((card["bn"][n] - v).abs().max()) for n, v in cpu["bn"].items())
    bn_over = max(float(((card["bn"][n] - v).abs() - BN_TOLERANCE["atol"]
                         - BN_TOLERANCE["rtol"] * v.abs()).max()) for n, v in cpu["bn"].items())
    if max(loss_rel.values()) > 1e-4 or grad_rel[worst] > 1e-3 or bn_over > 0:
        raise AssertionError(f"{phase}: card vs CPU step: losses {loss_rel}, gradient norm of "
                             f"{worst} {grad_rel[worst]}, BatchNorm {bn_err}")
    return {"loss_max_rel": max(loss_rel.values()), "grad_norm_max_rel": grad_rel[worst],
            "worst_tensor": worst, "bn_max_abs": bn_err,
            "tolerance": "losses 1e-4 relative, gradient norms 1e-3, BatchNorm statistics "
                         "1e-5 + 1e-5 relative"}


def dp_step_fields(trains: list, phase: str) -> dict:
    """The gates of `dp_train` over its ranks' lines, raising under `phase`'s
    name: every state tensor equal to rank 0's after the timed micro-steps
    and after the NaN dispatch, finite losses, 2 K4 and 1 K5 launches a
    micro-step a rank, the NaN micro-step skipped on every rank; then the
    step's fields a rank. `allreduce_share` is the all-reduce alone against
    the micro-step, `sync_share` the all-reduce and the barrier's wait
    before it (for the slowest rank) together."""
    skips = [float(i == 2) for i in range(MULTI_K)]
    for r, t in enumerate(trains):
        differ = t["ranks_differ"] + t["nan_dispatch"]["ranks_differ"]
        if differ:
            raise AssertionError(f"{phase}: rank {r} differs from rank 0 in {differ[:5]}")
        bad = [k for h in t["losses"] for k in LOSS_TERMS if not math.isfinite(h[k])]
        if bad or any(h["nonfinite_skip"] for h in t["losses"]):
            raise AssertionError(f"{phase}: rank {r}: non-finite {bad}")
        if t["launches"].get("K4", 0) != 2 * DP_STEPS or t["launches"].get("K5", 0) != DP_STEPS:
            raise AssertionError(f"{phase}: rank {r} launches {t['launches']}, want "
                                 f"{2 * DP_STEPS} K4 and {DP_STEPS} K5")
        if t["nan_dispatch"]["nonfinite_skip"] != skips:
            raise AssertionError(f"{phase}: rank {r} skips {t['nan_dispatch']['nonfinite_skip']} "
                                 f"in the NaN dispatch, want {skips}")
    step = [statistics.median(t["ms_per_step"]) for t in trains]
    reduce = [statistics.median(t["allreduce_host_ms"]) for t in trains]
    wait = [statistics.median(t["allreduce_wait_ms"]) for t in trains]
    return {"world": len(trains), "backend": trains[0]["backend"],
            "batch_global": trains[0]["batch_global"], "batch_rank": trains[0]["batch_rank"],
            "accum": trains[0]["accum"], "timed_steps": DP_STEPS,
            "ms_per_step_p50_by_rank": step,
            "ms_per_step_all_by_rank": [t["ms_per_step"] for t in trains],
            "allreduce_event_ms_p50_by_rank": [statistics.median(t["allreduce_event_ms"])
                                               for t in trains],
            "allreduce_host_ms_p50_by_rank": reduce, "allreduce_wait_ms_p50_by_rank": wait,
            "allreduce_share_by_rank": [h / s for h, s in zip(reduce, step)],
            "sync_share_by_rank": [(w + h) / s for w, h, s in zip(wait, reduce, step)],
            "allreduce_bytes": trains[0]["allreduce_bytes"],
            "peak_memory_gb_by_rank": [t["peak_memory_gb"] for t in trains],
            "state_tensors_bit_equal": trains[0]["tensors"],
            "launches_by_rank": [t["launches"] for t in trains],
            "losses_rank0": trains[0]["losses"],
            "nan_row_global": trains[0]["nan_dispatch"]["nan_row"],
            "nonfinite_skip_by_rank": [t["nan_dispatch"]["nonfinite_skip"] for t in trains]}


def sum_launches(per_rank) -> dict:
    total = {}
    for counts in per_rank:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def dp_phases(smi: str):
    """The data-parallel phases from two worker sessions on the card (one
    rank over NCCL; two ranks over gloo sharing the card) and one on the
    CPU (two gloo ranks): `dp_step`, `multi_step`, `sharded_serve` and
    `spatial` (each rank holds its serving outputs and spatial maps to one
    card's itself: `dp_serve`, `dp_spatial`). Launch counts of a multi-rank
    run are summed over its ranks; `sharded_serve` reports its 1-rank and
    2-rank runs apart. Returns the phase lines, the paths' launches and rank
    0's recorded inputs of the device warp on the 2-rank step
    (`dp_world2_worker`)."""
    one = run_ranks("dp_world1", 1, "nccl", "cuda", env=DETERMINISTIC_ENV)[0]
    two = run_ranks("dp_world2", 2, "gloo", "cuda")
    cpu = run_ranks("dp_reference", 2, "gloo", "cpu")
    lines, launches = [], {}

    # dp_step
    if one["dp_vs_plain"]["n_differ"] or not one["dp_vs_plain"]["aux_equal"]:
        raise AssertionError(f"dp_step: the world-1 DP step differs from the plain step: "
                             f"{one['dp_vs_plain']}")
    step = dp_step_fields(two, "dp_step")
    launches["dp_step"] = sum_launches(step["launches_by_rank"])
    lines.append({
        "phase": "dp_step", "model": "YOLOPoint-s", "dtype": "bf16", "card": smi,
        "world1_nccl": {"tensors_bit_equal": one["dp_vs_plain"]["tensors"],
                        "collectives": "none at world size 1"},
        "world2_gloo": step,
        "reference_n128": reference_fields(two[0]["reference"], cpu[0], "dp_step")})

    # multi_step
    for name in ("multi", "device_multi"):
        m = one[name]
        if m["n_differ"] or not m["aux_equal"] or \
                any(s != [MULTI_K] for s in m["aux_shapes"].values()):
            raise AssertionError(f"multi_step: {name} against {MULTI_K} single micro-steps: {m}")
    launches["multi_step"] = one["multi"]["launches"]
    launches["multi_step_rows"] = one["device_multi"]["launches"]
    lines.append({
        "phase": "multi_step", "k": MULTI_K, "accum": one["accum"], "card": smi,
        "deterministic_algorithms": one["deterministic"],
        "stacked": {"tensors_bit_equal": one["dp_vs_plain"]["tensors"],
                    "ms_per_micro_step": one["multi"]["ms_per_micro_step"],
                    "launches": one["multi"]["launches"]},
        "device_rows": {"resident_samples": one["device_multi"]["resident"],
                        "launches": one["device_multi"]["launches"]},
        "nan_dispatch_two_ranks": {"nonfinite_skip": step["nonfinite_skip_by_rank"][0]},
    })

    # sharded_serve
    launches["sharded_serve_world1"] = one["serve"]["launches"]
    launches["sharded_serve_world2"] = sum_launches(r["serve"]["launches"] for r in two)
    lines.append({"phase": "sharded_serve", "model": "YOLOPoint-s", "dtype": "f32",
                  "card": smi, "batch": DP_SERVE_BATCH,
                  "world1_nccl": one["serve"], "world2_gloo": [r["serve"] for r in two]})

    # spatial
    lines.append({"phase": "spatial", "model": "YOLOPoint-s", "dtype": "f32", "card": smi,
                  "world": 2, "backend": "gloo", "by_rank": [r["spatial"] for r in two]})
    return lines, launches, two[0]["warps"]


DRYRUN_SUMMARY = re.compile(r"dryrun_multichip\((\d+)\): loss=(\S+) param_delta=(\S+) "
                            r"spatial_semi=(\(.*?\)) wall=(\S+)s OK")


def dryrun_phase(smi, runs=((2, "gloo"), (1, "nccl"))) -> dict:
    """`python -m yolopoint_tpu_torch.parallel.dryrun` on the card or cards,
    once for each `(nproc, backend)` of `runs`: by default 2 ranks over gloo
    sharing the one card, and 1 over NCCL. Each prints the JAX gate's
    summary fields, with a finite loss."""
    out = []
    for nproc, backend in runs:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "yolopoint_tpu_torch.parallel.dryrun",
                               "--nproc", str(nproc), "--device", "cuda", "--backend", backend,
                               "--timeout", "300"],
                              cwd=REPO, capture_output=True, text=True, timeout=360)
        m = DRYRUN_SUMMARY.search(proc.stdout)
        if proc.returncode != 0 or not m or not math.isfinite(float(m.group(2))):
            raise AssertionError(f"dryrun --nproc {nproc}: rc {proc.returncode}\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        out.append({"nproc": nproc, "backend": backend, "summary": m.group(0),
                    "loss": float(m.group(2)), "param_delta": float(m.group(3)),
                    "spatial_semi": m.group(4), "wall_s": float(m.group(5)),
                    "command_s": time.perf_counter() - t0})
    return {"phase": "dryrun", "card": smi, "runs": out}


FIT_DP_OVERRIDES = {"training_params": {"steps_per_dispatch": 4,
                                        "profile": {"start_step": 4, "num_steps": 4}}}
FIT_DP_TIMEOUT = 300  # seconds each torchrun of fit_dp may take


def torchrun_cli(world: tuple, argv: list) -> tuple[str, float]:
    """`torchrun --standalone --nproc_per_node nproc -m
    yolopoint_tpu_torch.training.cli argv` at `world` = (nproc, backend),
    gloo asked for by name; returns its output and wall."""
    nproc, backend = world
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), "-m", "yolopoint_tpu_torch.training.cli", *argv,
           *(["--backend", "gloo"] if backend == "gloo" else [])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=FIT_DP_TIMEOUT)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"fit_dp: torchrun --nproc_per_node {nproc} failed "
                             f"({proc.returncode}):\n{log[-6000:]}")
    return log, time.perf_counter() - t0


def trace_summary(path: Path) -> dict:
    """A profiler trace's `micro_step` ranges (the host's; the card's copies
    are "gpu_user_annotation"), kernels, warp and NCCL kernels, kernel ms."""
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"micro_steps": sum(e.get("name") == "micro_step"
                               and e.get("cat") == "user_annotation" for e in events),
            "kernels": len(kernels),
            "warp_kernels": sum("warp_kernel" in e.get("name", "") for e in kernels),
            "nccl_kernels": sum("nccl" in e.get("name", "").lower() for e in kernels),
            "kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3}


def log_records(log: str, tag: str) -> list:
    return [json.loads(line.split(tag + " ", 1)[1]) for line in log.splitlines()
            if f"{tag} {{" in line]


def fit_dp(seed: int, smi, world=(1, "nccl"), host_world=(2, "gloo"),
           fit_line: dict | None = None, device: str = "cuda"):
    """The training CLI under torchrun on `fit`'s config with
    `FIT_DP_OVERRIDES` (2 epochs of 4 micro-steps, one dispatch of K = 4 an
    epoch on the resident set, the profiler window over micro-steps 4-7) at
    `world` = (ranks, backend), then `--resume` to 3 epochs, then 1 epoch at
    `host_world` on the CLI's default warp path (`host_warp` unset: the host
    on 4 or more cores). By default the one card: 1 rank over NCCL, then 2
    over gloo, asked for by name (NCCL cannot put two ranks on one GPU).
    Checks each rank's log line (`rank r of world size n on <device>
    (<backend>)`), epoch timing, launches (K5 on every rank, K4 where it
    warps on the card) and peak bytes on the other cards (0); rank 0's
    files, one trace a rank of exactly the window's 4 micro-steps holding
    warp kernels, the resume (epoch 2 to global step 12). Returns the phase
    line and each run's launches a rank."""
    from yolopoint_tpu_torch.utils.config import dict_update, save_config

    on_card = device == "cuda"
    nproc = world[0]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = dict_update(dict_update(s640_train_config(), FIT_OVERRIDES), FIT_DP_OVERRIDES)
        save_config(cfg, tmp / "fit.yaml")
        base = ["--config", str(tmp / "fit.yaml"), "--output_dir", str(tmp / "logs"),
                "--data_root", str(tmp / "data"), "--seed", str(seed), "--device", device]
        log1, wall1 = torchrun_cli(world, base + ["--exper_name", "fit"])
        run = tmp / "logs" / "fit"
        files1 = sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())
        done1 = json.loads((run / "done.json").read_text())
        traces = [trace_summary(run / "profile" / f"rank{r}.json") for r in range(nproc)]
        dict_update(cfg, {"training_params": {"epochs": 3}})
        save_config(cfg, tmp / "fit.yaml")
        log2, wall2 = torchrun_cli(world, base + ["--exper_name", "fit", "--resume"])
        done2 = json.loads((run / "done.json").read_text())
        dict_update(cfg, {"training_params": {"epochs": 1, "profile": None}})
        del cfg["data"]["augmentation"]["host_warp"]  # the CLI's rule decides
        save_config(cfg, tmp / "fit.yaml")
        log3, wall3 = torchrun_cli(host_world, base + ["--exper_name", "host"])
        run3 = tmp / "logs" / "host"
        files3 = sorted(str(p.relative_to(run3)) for p in run3.rglob("*") if p.is_file())

    runs = {}
    for name, log, (n, backend) in (("fit", log1, world), ("resume", log2, world),
                                    ("host_path", log3, host_world)):
        timing, counts = log_records(log, "epoch_timing"), log_records(log, "kernel_launches")
        other = {o["rank"]: o["peak_bytes"] for o in log_records(log, "other_cards")}
        ranks = sorted({t["rank"] for t in timing})
        if ranks != list(range(n)) or sorted(c["rank"] for c in counts) != ranks or \
                sorted(other) != ranks:
            raise AssertionError(f"fit_dp {name}: epoch timings of ranks {ranks}, launches of "
                                 f"{[c['rank'] for c in counts]}, other cards of "
                                 f"{sorted(other)}\n{log[-3000:]}")
        if any(any(b.values()) for b in other.values()):
            raise AssertionError(f"fit_dp {name}: ranks allocated on other cards: {other}")
        for r in range(n):
            where = (f"cuda:{r if backend == 'nccl' else 0} ({backend})" if on_card
                     else "cpu (gloo)")
            if sum(f"rank {r} of world size {n} on {where}" in line
                   for line in log.splitlines()) != 1:
                raise AssertionError(f"fit_dp {name}: no single 'rank {r} of world size {n} on "
                                     f"{where}' in\n{log[-3000:]}")
        by_rank = [{k: v for k, v in c.items() if k != "rank"}
                   for c in sorted(counts, key=lambda c: c["rank"])]
        if on_card and any(c.get("K5", 0) <= 0 for c in by_rank):
            raise AssertionError(f"fit_dp {name}: launches {by_rank}")
        runs[name] = {"world": n, "backend": backend, "epoch_timing": timing,
                      "threads": log_records(log, "threads"),
                      "warp_path_by_rank": ["device" if c.get("K4", 0) else "host"
                                            for c in by_rank],
                      "launches_by_rank": by_rank,
                      "other_cards_peak_bytes_by_rank": [other[r] for r in range(n)]}
    host_logged = "augmentation warp path: host" in log3
    if on_card and (runs["fit"]["warp_path_by_rank"] + runs["resume"]["warp_path_by_rank"]
                    != ["device"] * 2 * nproc or runs["host_path"]["warp_path_by_rank"]
                    != ["host" if host_logged else "device"] * host_world[0]):
        raise AssertionError(f"fit_dp: warp paths {[r['warp_path_by_rank'] for r in runs.values()]}"
                             f", rank 0 logged the host path: {host_logged}")
    want = {"config.yml", "metrics.jsonl", "done.json", "ckpts/0.pt", "ckpts/1.pt",
            *(f"profile/rank{r}.json" for r in range(nproc))}
    if not want <= set(files1) or (done1["last_epoch"], done1["global_step"]) != (1, 8):
        raise AssertionError(f"fit_dp: run 1 wrote {files1}, done {done1}")
    if any(t["micro_steps"] != 4 or (on_card and not t["warp_kernels"]) for t in traces):
        raise AssertionError(f"fit_dp: traces {traces} (want 4 micro-steps and warp kernels)")
    if log2.count("resumed from epoch 2") != nproc or \
            (done2["last_epoch"], done2["global_step"]) != (2, 12):
        raise AssertionError(f"fit_dp: resume done {done2}\n{log2[-2000:]}")
    if "done.json" not in files3 or any(f.startswith("profile") for f in files3):
        raise AssertionError(f"fit_dp: the host-path run wrote {files3}")
    line = {"phase": "fit_dp", "card": smi, "overrides": FIT_DP_OVERRIDES,
            "wall_s": {"fit": wall1, "resume": wall2, "host_path": wall3}, "files": files1,
            "done": done1, "done_resume": done2, "traces_by_rank": traces,
            "ms_per_micro_step_by_epoch_rank0": [
                t["train_s"] * 1e3 / t["micro_steps"] for t in runs["fit"]["epoch_timing"]
                if t["rank"] == 0 and t["micro_steps"]],
            "host_path_logged": host_logged, **runs}
    if fit_line:
        line["single_process_fit"] = {"epoch_s": fit_line["epoch_s"],
                                      "ms_per_step_p50": fit_line["ms_per_step_p50"]}
    return line, {"fit_dp": runs["fit"]["launches_by_rank"],
                  "fit_dp_resume": runs["resume"]["launches_by_rank"],
                  "fit_dp_host": runs["host_path"]["launches_by_rank"]}


# ---------------------------------------------------------------- four cards

CARDS = 4  # `--cards 4`: one NCCL rank a card of one host
CARDS_PHASES = ("dryrun4", "dp_step4", "multi_step4", "dp_reference4", "sharded_serve4",
                "spatial4", "fit_dp4")
# the phases in worker sessions, one session a group
CARDS_SESSIONS = (("dp_step4", "multi_step4", "dp_reference4"), ("sharded_serve4", "spatial4"))
CARDS_SESSION_TIMEOUT = 300  # seconds a four-card worker session may take, start-up included
CARDS_SERVE_BATCH = 64  # global: 16 a rank
CARDS_SERVE_REPS = 5
SPATIAL_LAYOUTS = ((1, 4), (2, 2))  # (data, spatial): 160 and 320 rows a shard at 640
NCCL_ENV = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT"}  # the transports, in the logs


def require_cards() -> int:
    """The visible card count; raises, naming it, where fewer than `CARDS`
    are visible. The four-card mode runs one NCCL rank a card and never
    drops to gloo, to fewer ranks or to the CPU."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < CARDS:
        raise RuntimeError(f"--cards {CARDS}: {count} CUDA device(s) visible, {CARDS} needed "
                           "(one NCCL rank a card; no fallback to gloo, to fewer ranks or to "
                           "the CPU)")
    return count


def cards_info() -> dict:
    """Every card's index, name and power limit, the device count, NCCL's
    version and `nvidia-smi topo -m` (NVLink or PCIe between the cards;
    where it cannot read the topology, NCCL's transports in
    `nccl_transports` say how the cards are joined)."""
    def smi(*args) -> list:
        proc = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
        if proc.returncode == 0:
            return proc.stdout.strip().splitlines()
        return [f"nvidia-smi {' '.join(args)} failed ({proc.returncode})",
                *(proc.stdout + proc.stderr).strip().splitlines()[-5:]]

    nccl = torch.cuda.nccl.version()
    return {"phase": "cards", "device_count": torch.cuda.device_count(),
            "cards": smi("--query-gpu=index,name,power.limit", "--format=csv,noheader"),
            "name_power": smi("--query-gpu=name,power.limit", "--format=csv,noheader"),
            "nccl_version": ".".join(map(str, nccl)) if isinstance(nccl, tuple) else nccl,
            "torch": torch.__version__, "cuda": torch.version.cuda, "cpu_count": os.cpu_count(),
            "topology": smi("topo", "-m")}


def nccl_transports(log: str) -> dict:
    """Counts of the channel transports NCCL's INIT log names (`via P2P/...`,
    `via NVLS`, `via SHM`, `via NET/...`) and whether NVLS was on offer."""
    counts = {}
    for m in re.finditer(r" via (\S+)", log):
        counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return {"channels_by_transport": counts,
            "nvls_multicast": "NVLS multicast support is available" in log}


def on_own_card(mesh) -> None:
    """A rank of the four-card session runs over NCCL on `cuda:<rank>`, its
    current device."""
    own = torch.device("cuda", mesh.rank)
    if mesh.backend != "nccl" or mesh.device != own or torch.cuda.current_device() != mesh.rank:
        raise AssertionError(f"rank {mesh.rank}: backend {mesh.backend} on {mesh.device} "
                             f"(current {torch.cuda.current_device()}), want nccl on {own}")


def checked(check, *args) -> dict:
    """A kernel check's line with the launches the check made and its card."""
    from yolopoint_tpu_torch.ops import _build

    before = sum(_build.launch_counts.values())
    line = check(*args)
    line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
    line["device"] = torch.cuda.current_device()
    return line


def cards_worker(mesh, phases: str) -> dict:
    """One rank of a four-card session: the phases named in `phases` (a
    comma-separated group of `CARDS_SESSIONS`) on this rank's card,
    then its recorded kernel inputs (K4 and K5 from `dp_train`, K1, K2 and
    K3 from `dp_serve`; K2's tiles must hold valid boxes) held against their
    plain versions on this card: exact, K3 within 1e-5; and this process's
    peak bytes on the other cards."""
    from yolopoint_tpu_torch.parallel.mesh import foreign_card_bytes

    phases = phases.split(",")
    on_own_card(mesh)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend,
           "kernel_checks": []}
    if "dp_step4" in phases or "multi_step4" in phases:
        out["train"], warps = dp_train(mesh)
        for img, hom, mode in warps.values():
            line = checked(check_warp_on, img, hom, mode, 10, "recorded")
            if line["max_abs_err"] != 0:
                raise AssertionError(f"rank {mesh.rank}: warp {line['shape']} {mode} off by "
                                     f"{line['max_abs_err']}")
            out["kernel_checks"].append(dict(line, path="dp_step4"))
        del warps
        torch.cuda.empty_cache()
    if "dp_reference4" in phases:
        out["reference"] = dp_reference(mesh)
    if "sharded_serve4" in phases:
        out["serve"], rec = dp_serve(mesh, CARDS_SERVE_BATCH, CARDS_SERVE_REPS)
        for hm, conf, r, it, border, tile in rec["k1"].values():
            out["kernel_checks"].append(dict(checked(check_k1_on, hm, conf, r, it, border, 10,
                                                     tile), path="sharded_serve4"))
        k2 = checked(check_k2_tiles, rec["tiles"])
        if not k2["valid"]:
            raise AssertionError(f"rank {mesh.rank}: K2's recorded tiles hold no valid box")
        out["kernel_checks"].append(dict(k2, path="sharded_serve4", input="recorded"))
        for desc, pts, cell in rec["k3"].values():
            out["kernel_checks"].append(dict(checked(check_k3_on, desc, pts, cell, 10),
                                             path="sharded_serve4"))
        del rec
        torch.cuda.empty_cache()
    if "spatial4" in phases:
        out["spatial"] = [dp_spatial(mesh, data, spatial) for data, spatial in SPATIAL_LAYOUTS]
    out["foreign_card_bytes"] = foreign_card_bytes(mesh)
    return out


DP_WORKERS["cards"] = cards_worker


def cards_lines(ranks: list, smi: list, logs: list) -> tuple[list, dict, dict]:
    """The four-card session's phase lines from its ranks' results, each
    phase's gates applied (`dp_step_fields`; `dp_serve` and `dp_spatial`
    gate on each rank); the paths' launches a rank; each kernel's check a
    rank at its largest recorded input (`{key: [line a rank]}`)."""
    lines, launches = [], {}
    card = {"cards": smi, "nccl": nccl_transports(logs[0])}
    for r in ranks:
        if any(r["foreign_card_bytes"].values()):
            raise AssertionError(f"rank {r['rank']} allocated on other cards: "
                                 f"{r['foreign_card_bytes']}")
    if "train" in ranks[0]:
        step = dp_step_fields([r["train"] for r in ranks], "dp_step4")
        launches["dp_step4"] = step["launches_by_rank"]
        lines.append({"phase": "dp_step4", "model": "YOLOPoint-s", "dtype": "bf16", **card,
                      **step})
        lines.append({"phase": "multi_step4", "k": MULTI_K, **card,
                      "nan_row_global": step["nan_row_global"],
                      "nonfinite_skip_by_rank": step["nonfinite_skip_by_rank"],
                      "state_tensors_bit_equal": step["state_tensors_bit_equal"]})
    if "serve" in ranks[0]:
        serves = [r["serve"] for r in ranks]
        launches["sharded_serve4"] = [s["launches"] for s in serves]
        lines.append({"phase": "sharded_serve4", "model": "YOLOPoint-s", "dtype": "f32", **card,
                      "world": len(ranks), "batch": CARDS_SERVE_BATCH,
                      "ms_p50_by_rank": [s["ms_p50"] for s in serves],
                      "one_card_ms_p50_by_rank": [s["one_card_ms_p50"] for s in serves],
                      "by_rank": serves})
    if "spatial" in ranks[0]:
        lines.append({"phase": "spatial4", "model": "YOLOPoint-s", "dtype": "f32", **card,
                      "world": len(ranks), "by_rank": [r["spatial"] for r in ranks]})
    checks = {}
    for r in ranks:
        for key in sorted({c["kernel"] for c in r["kernel_checks"]}):
            mine = [c for c in r["kernel_checks"] if c["kernel"] == key]
            checks.setdefault(key, []).append(max(mine, key=lambda c: math.prod(c["shape"])))
    return lines, launches, checks


# ---------------------------------------------------------------- serving artifact, demo

AOT_BATCHES = (1, 16)
AOT_REQUESTS = (20, 8)
AOT_SIZE = 640
DESC_ATOL = 1e-4  # the serve phase's unit-norm tolerance, for descriptors of two runs


def same_serving(got: dict, want: dict, what: str) -> dict:
    """Two serving outputs of the same inputs on the card: keypoints, their
    scores and validity, and the box slots equal; descriptors within
    `DESC_ATOL`."""
    exact = ("keypoints", "kp_scores", "kp_valid", "boxes", "box_scores", "box_classes",
             "box_valid", "box_n_candidates")
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys {sorted(got)} vs {sorted(want)}")
    for k in exact:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs")
    err = float((got["descriptors"] - want["descriptors"]).abs().max())
    if not err <= DESC_ATOL:
        raise AssertionError(f"{what}: descriptors differ by {err} > {DESC_ATOL}")
    return {"keypoints": int(want["kp_valid"].sum()), "boxes": int(want["box_valid"].sum()),
            "desc_max_abs": err}


@contextlib.contextmanager
def direct_wrappers():
    """The serving path with K1, K2 and K3 called through their ctypes
    wrappers directly, as before they were `torch.library` ops (the eager
    path's dispatcher hop taken out, to time it)."""
    from yolopoint_tpu_torch.ops import cuda_gather, cuda_nms, library
    from yolopoint_tpu_torch.ops import nms as nms_module

    real = (library.nms_tile_keys, library.sample_descriptors, nms_module.greedy_nms_keep)
    library.nms_tile_keys = cuda_nms.nms_tile_keys
    library.sample_descriptors = cuda_gather.sample_descriptors_cuda
    nms_module.greedy_nms_keep = library.cuda_box_nms.greedy_nms_keep
    try:
        yield
    finally:
        library.nms_tile_keys, library.sample_descriptors, nms_module.greedy_nms_keep = real


def aot(seed: int, device: str = "cuda"):
    """The serving artifact (`export.aot`) of YOLOPoint-S at 640 px, bf16,
    BN folded, seeded weights, the `serve` operating point, exported on the
    card at B = 1 and at B = 16: export seconds and file bytes, reloaded
    (`load_serving_artifact`, its own seconds), then ms a request of the
    loaded program and of the eager pipeline on the same float images, in
    turns; the outputs held against the eager pipeline's (`same_serving`);
    K1, K2 and K3 launched once a request by the loaded program (launch
    deltas around its requests alone). Also eager serving with the kernels
    as `torch.library` ops against their wrappers called directly
    (`direct_wrappers`), in turns: the dispatcher's cost a request."""
    from yolopoint_tpu_torch.export import aot as aot_module
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.ops import _build

    model = folded_yolopoint_s(seed, torch.bfloat16, device)
    pipe = InferencePipeline(model, SERVE_CONFIG, compute_dtype=torch.bfloat16, device=device)
    gen = torch.Generator().manual_seed(seed + 2)
    per_batch, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for B, n in zip(AOT_BATCHES, AOT_REQUESTS):
            x = (torch.randint(0, 256, (B, AOT_SIZE, AOT_SIZE, 3), dtype=torch.uint8,
                               generator=gen).to(device).float() / 255.0)
            path = Path(tmp) / f"yolopoint_s_b{B}.pt2"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aot_module.save_serving_artifact(path, model, None, SERVE_CONFIG, batch=B,
                                             height=AOT_SIZE, width=AOT_SIZE,
                                             compute_dtype=torch.bfloat16, device=device)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            serving = aot_module.load_serving_artifact(path, device=device)
            load_s = time.perf_counter() - t0
            for _ in range(2):  # warm-up: cuDNN plans, allocator
                serving(x)
                pipe(x)
            torch.cuda.synchronize()
            times = {"artifact": [], "eager": [], "eager_ops": [], "eager_direct": []}
            before = dict(_build.launch_counts)
            for _ in range(n):
                t0 = time.perf_counter()
                got = serving(x)
                torch.cuda.synchronize()
                times["artifact"].append((time.perf_counter() - t0) * 1e3)
            delta = {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()
                     if v != before.get(k, 0)}
            for k in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors"):
                if device == "cuda" and delta.get(k) != n:
                    raise AssertionError(f"aot B={B}: {n} requests launched {k} "
                                         f"{delta.get(k, 0)} times: {delta}")
            launches[B] = delta
            for i in range(n):
                t0 = time.perf_counter()
                want = pipe(x)
                torch.cuda.synchronize()
                times["eager"].append((time.perf_counter() - t0) * 1e3)
                for key in (("eager_ops", "eager_direct") if i % 2 == 0
                            else ("eager_direct", "eager_ops")):
                    with direct_wrappers() if key == "eager_direct" else contextlib.nullcontext():
                        t0 = time.perf_counter()
                        pipe(x)
                        torch.cuda.synchronize()
                        times[key].append((time.perf_counter() - t0) * 1e3)
            with direct_wrappers():
                direct = pipe(x)
            per_batch[str(B)] = {
                "export_s": export_s, "load_s": load_s, "artifact_bytes": path.stat().st_size,
                "ms_p50": {k: statistics.median(v) for k, v in times.items()},
                "ms_all": times, "launches": delta,
                "against_eager": same_serving(got, want, f"aot B={B}"),
                "direct_against_ops": same_serving(direct, want, f"direct B={B}"),
                "graph_ops": sorted({str(nd.target) for nd in serving.program.graph.nodes
                                     if str(nd.target).startswith("yolopoint.")}),
            }
    total = sum_launches(launches.values())
    return {"phase": "aot", "model": "YOLOPoint-s", "nc": 80, "input": [AOT_SIZE, AOT_SIZE],
            "dtype": "bf16 fused", "config": SERVE_CONFIG, "batches": per_batch,
            "launches": total}, total


DEMO_FRAMES = 8
DEMO_SIZE = (480, 640)
DEMO_DETECT_BIAS = 4.5  # raises the seeded Detect head's scores: some boxes pass conf 0.25
DEMO_TIMEOUT = 300
DEMO_PHASES = ("read_ms", "infer_ms", "draw_ms", "encode_ms")


def demo_phase(seed: int, device: str = "cuda"):
    """`python -m yolopoint_tpu_torch.frontend.demo --track --save-dir
    --timing` on `DEMO_FRAMES` panning 480x640 frames that the port's own
    writers wrote (every other one PNG by `write_png`, JPEG by `write_jpeg`),
    with a seeded YOLOPoint-S file (nc = 80, Detect biases raised by
    `DEMO_DETECT_BIAS`) on the default deploy path (bf16, BN folded, 640
    px): its printed line a frame and its timing line (ms a frame reading,
    in the pipeline, tracking and drawing, encoding; its launches). Then
    `demo.main` again in this process with the same arguments, the drawn
    frames captured at the encoder: each saved file of the command decodes
    (the compiled decoder) to 480x640 and is byte-equal to this process's
    file and to the numpy twin's encoding of the same drawing. Also the
    encoder alone on one drawn frame, compiled against the numpy twin."""
    from yolopoint_tpu_torch.data import jpeg
    from yolopoint_tpu_torch.data.png import write_png
    from yolopoint_tpu_torch.frontend import demo
    from yolopoint_tpu_torch.ops import _build

    H, W = DEMO_SIZE
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        frames = tmp / "frames"
        frames.mkdir()
        for i, img in enumerate(panning_frames(seed, DEMO_FRAMES, H, W, step=4)):
            if i % 2:
                jpeg.write_jpeg(frames / f"{i:03d}.jpg", img)
            else:
                write_png(frames / f"{i:03d}.png", img)
        weights = tmp / "yolopoint_s.pt"
        save_reference_weights(weights, seed, version="s", names=[f"c{i}" for i in range(80)],
                               detect_bias=DEMO_DETECT_BIAS)
        args = ["--weights", str(weights), "--input", str(frames), "--track", "--timing",
                "--device", device]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "yolopoint_tpu_torch.frontend.demo", *args,
                               "--save-dir", str(tmp / "out")], cwd=REPO, capture_output=True,
                              text=True, timeout=DEMO_TIMEOUT)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"demo: the command failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-4000:]}")
        lines = proc.stdout.strip().splitlines()
        timing = json.loads(lines[-1])
        frame_lines = lines[:-1]
        for k in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors"):
            if device == "cuda" and timing["launches"].get(k) != DEMO_FRAMES:
                raise AssertionError(f"demo: {k} launched {timing['launches']} for "
                                     f"{DEMO_FRAMES} frames")

        drawn = []
        real = jpeg.write_jpeg

        def capture(path, img, device="cuda"):
            drawn.append(img.copy())
            real(path, img, device)

        jpeg.write_jpeg = capture
        try:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                demo.main(args + ["--save-dir", str(tmp / "again")])
        finally:
            jpeg.write_jpeg = real
        if out.getvalue().strip().splitlines()[:-1] != frame_lines:
            raise AssertionError("demo: the in-process run printed other counts:\n"
                                 f"{out.getvalue()[-2000:]}\nvs\n{proc.stdout[-2000:]}")
        names = sorted(p.name for p in (tmp / "out").iterdir())
        if names != [f"{i:03d}.jpg" for i in range(DEMO_FRAMES)] or len(drawn) != DEMO_FRAMES:
            raise AssertionError(f"demo: wrote {names}, drew {len(drawn)}")
        equal = 0
        for name, img in zip(names, drawn):
            data = (tmp / "out" / name).read_bytes()
            dec = jpeg.decode_jpeg(data, name, device=device)
            if dec.shape != (H, W, 3):
                raise AssertionError(f"demo: {name} decodes to {dec.shape}")
            if data != (tmp / "again" / name).read_bytes() or data != jpeg.encode_numpy(img):
                raise AssertionError(f"demo: {name} differs from this process's drawing "
                                     "or from the numpy twin's encoding of it")
            equal += 1
        img = drawn[-1]
        enc = {"compiled_ms": statistics.median(
            _timed_ms(lambda: jpeg.encode_jpeg(img, device=device)) for _ in range(10)),
            "numpy_ms": statistics.median(_timed_ms(lambda: jpeg.encode_numpy(img))
                                          for _ in range(3))}
    counts = [tuple(int(w) for w in re.findall(r"(\d+) (?:keypoints|boxes)", s))
              for s in frame_lines]
    if not any(b for _, b in counts) or not all(k for k, _ in counts):
        raise AssertionError(f"demo: keypoints and boxes a frame {counts}")
    launches = {k: v for k, v in timing["launches"].items()}
    return {"phase": "demo", "model": "YOLOPoint-s", "nc": 80, "frames": DEMO_FRAMES,
            "frame_size": list(DEMO_SIZE), "dtype": "bf16 fused", "command_s": wall,
            # the command's first frame pays its CUDA and cuDNN start-up
            "first_frame_ms": {k: timing[k][0] for k in DEMO_PHASES},
            "per_frame_ms_p50": {k: statistics.median(timing[k][1:]) for k in DEMO_PHASES},
            "per_frame_ms": {k: timing[k] for k in DEMO_PHASES},
            "keypoints_boxes": counts, "files_equal_twin": equal,
            "jpeg_encode_640x480": enc, "launches": launches}, launches


DEMO_KINDS_SIZE = (240, 320)


def demo_kinds_phase(seed: int, device: str = "cuda"):
    """`demo.main` in this process over a directory of `image_kind_files`
    (240x320 frames) with a seeded YOLOPoint-S file (Detect biases raised by
    `DEMO_DETECT_BIAS`), the launch counts from 0 around it: the stems it
    served and skipped are `IMAGE_KINDS_SERVED` and `IMAGE_KINDS_SKIPPED`
    (what the JAX demo serves and skips), one K1, K2 and K3 launch a served
    frame; each served file's read on this path (compiled host code for
    JPEG and the grey conversions) equal to the numpy read; the ms of each
    read (the skipped files' attempts counted with the next served one's)."""
    from yolopoint_tpu_torch.data.datasets import _imread
    from yolopoint_tpu_torch.frontend import demo
    from yolopoint_tpu_torch.ops import _build

    H, W = DEMO_KINDS_SIZE
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        frames = tmp / "frames"
        frames.mkdir()
        files = image_kind_files(seed, H, W)
        for name, data in files.items():
            (frames / name).write_bytes(data)
        weights = tmp / "yolopoint_s.pt"
        save_reference_weights(weights, seed, version="s", names=[f"c{i}" for i in range(80)],
                               detect_bias=DEMO_DETECT_BIAS)
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        refuse = no_numpy_decoders() if device == "cuda" else contextlib.nullcontext()
        with contextlib.redirect_stdout(io.StringIO()) as out, refuse:
            demo.main(["--weights", str(weights), "--input", str(frames), "--timing",
                       "--device", device])
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        lines = out.getvalue().strip().splitlines()
        timing = json.loads(lines[-1])
        served = [ln.split(":")[0] for ln in lines[:-1]]
        skipped = sorted({Path(n).stem for n in files} - set(served))
        if served != list(IMAGE_KINDS_SERVED) or skipped != list(IMAGE_KINDS_SKIPPED):
            raise AssertionError(f"demo_kinds: served {served}, skipped {skipped}")
        for k in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors"):
            if device == "cuda" and launches.get(k) != len(served):
                raise AssertionError(f"demo_kinds: {k} launched {launches} for {len(served)} "
                                     "frames")
        for name in sorted(files):
            if Path(name).stem in served and not np.array_equal(
                    _imread(str(frames / name), device), _imread(str(frames / name), "cpu")):
                raise AssertionError(f"demo_kinds: {name} reads otherwise than in numpy")
    counts = [tuple(int(w) for w in re.findall(r"(\d+) (?:keypoints|boxes)", ln))
              for ln in lines[:-1]]
    if not all(k for k, _ in counts):
        raise AssertionError(f"demo_kinds: keypoints and boxes a frame {counts}")
    return {"phase": "demo_kinds", "model": "YOLOPoint-s", "frame_size": list(DEMO_KINDS_SIZE),
            "files": len(files), "served": served, "skipped": skipped, "command_s": wall,
            "read_ms": dict(zip(served, timing["read_ms"])),
            "infer_ms_p50": statistics.median(timing["infer_ms"]),
            "keypoints_boxes": counts, "reads_equal_numpy": len(served),
            "launches": launches}, launches


VIDEO_DIR = REPO / "tests" / "data" / "video"  # tools/make_video_fixtures.py
DEMO_VIDEO = "mp4v_480x640.mp4"


def video_phase(seed: int) -> dict:
    """Each video fixture read on the card's path (compiled host code) and in
    numpy: every frame's SHA-256 equal to cv2's (`video_fixtures.json`, the
    machine has no OpenCV) and the two reads equal; each codec's p50 ms a
    frame (compiled: 3 passes; numpy: 1), the frames' decode alone (the
    file read and demux once, before)."""
    import hashlib

    from yolopoint_tpu_torch.data import video

    index = json.loads((VIDEO_DIR / "video_fixtures.json").read_text())
    per_codec: dict = {}
    files = {}
    for name, entry in index["files"].items():
        path = VIDEO_DIR / name

        def frame_ms(device):
            times, frames = [], []
            it = video.read_video(path, device)
            while True:
                t0 = time.perf_counter()
                frame = next(it, None)
                if frame is None:
                    break
                times.append((time.perf_counter() - t0) * 1e3)
                frames.append(frame)
            return times, frames

        compiled_ms, frames = [], []
        for _ in range(3):
            ms, frames = frame_ms("cuda")
            compiled_ms += ms[1:] if len(ms) > 1 else ms  # the first pays the file read
        numpy_ms, numpy_frames = frame_ms("cpu")
        digests = [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]
        if digests != entry["sha256"]:
            bad = [i for i, (a, b) in enumerate(zip(digests, entry["sha256"])) if a != b]
            raise AssertionError(f"video: {name} frames {bad} (of {len(digests)}, cv2 "
                                 f"{len(entry['sha256'])}) are not cv2's")
        if len(numpy_frames) != len(frames) or not all(
                np.array_equal(a, b) for a, b in zip(frames, numpy_frames)):
            raise AssertionError(f"video: {name} decodes otherwise in numpy")
        codec = entry["codec"]
        per_codec.setdefault(codec, {"compiled": [], "numpy": []})
        per_codec[codec]["compiled"] += compiled_ms
        per_codec[codec]["numpy"] += numpy_ms[1:] if len(numpy_ms) > 1 else numpy_ms
        files[name] = {"frames": len(frames), "shape": entry["shape"], "equal_cv2": True,
                       "equal_numpy": True}
    return {"phase": "video", "files": files,
            "ms_per_frame_p50": {c: {k: statistics.median(v) for k, v in t.items()}
                                 for c, t in per_codec.items()},
            "cpu_count": os.cpu_count()}


def demo_video_phase(seed: int, device: str = "cuda"):
    """`demo.main` in this process on the MPEG-4 Part 2 fixture with a seeded
    YOLOPoint-S file (Detect biases raised by `DEMO_DETECT_BIAS`), the launch
    counts from 0 around it and every numpy decoder refused: the frames
    served are the fixture's (named `000000`, ... as the JAX demo names a
    video's frames), one K1, K2 and K3 launch a frame, keypoints on every
    frame; the read and infer ms of each frame (the first pays the process's
    first decode of the file)."""
    from yolopoint_tpu_torch.frontend import demo
    from yolopoint_tpu_torch.ops import _build

    entry = json.loads((VIDEO_DIR / "video_fixtures.json").read_text())["files"][DEMO_VIDEO]
    with tempfile.TemporaryDirectory() as tmp:
        weights = Path(tmp) / "yolopoint_s.pt"
        save_reference_weights(weights, seed, version="s", names=[f"c{i}" for i in range(80)],
                               detect_bias=DEMO_DETECT_BIAS)
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        refuse = no_numpy_decoders() if device == "cuda" else contextlib.nullcontext()
        with contextlib.redirect_stdout(io.StringIO()) as out, refuse:
            demo.main(["--weights", str(weights), "--input", str(VIDEO_DIR / DEMO_VIDEO),
                       "--timing", "--device", device])
        wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    lines = out.getvalue().strip().splitlines()
    timing = json.loads(lines[-1])
    served = [ln.split(":")[0] for ln in lines[:-1]]
    if served != [f"{i:06d}" for i in range(entry["frames"])]:
        raise AssertionError(f"demo_video: served {served}, the fixture has {entry['frames']} "
                             "frames")
    for k in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors"):
        if device == "cuda" and launches.get(k) != len(served):
            raise AssertionError(f"demo_video: {k} launched {launches} for {len(served)} "
                                 "frames")
    counts = [tuple(int(w) for w in re.findall(r"(\d+) (?:keypoints|boxes)", ln))
              for ln in lines[:-1]]
    if not all(k for k, _ in counts):
        raise AssertionError(f"demo_video: keypoints and boxes a frame {counts}")
    return {"phase": "demo_video", "model": "YOLOPoint-s", "input": DEMO_VIDEO,
            "frame_size": entry["shape"][:2], "frames": len(served), "command_s": wall,
            "read_ms": timing["read_ms"], "infer_ms": timing["infer_ms"],
            "read_ms_p50": statistics.median(timing["read_ms"]),
            "infer_ms_p50": statistics.median(timing["infer_ms"]),
            "keypoints_boxes": counts, "launches": launches}, launches


ROS_FRAMES = 12
ROS_FRAME = (720, 1280)
ROS_ENCODINGS = {3: "rgb8", 6: "bgra8", 9: "mono8"}  # message index -> encoding; else bgr8
ROS_ROW_PAD = 64  # bytes of padding after each row of the bgra8 message
ROS_LAUNCH = "yolopoint_tpu_torch/deploy/ros_pkg/launch/yolopoint.launch"
ROS_KERNELS = ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors")


class RosBag:
    """Attribute bag standing in for a rospy message instance."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


@contextlib.contextmanager
def fake_ros(params: dict):
    """rospy, sensor_msgs, keypoint_msg, object_msgs and message_filters
    stand-ins in `sys.modules` (the card's machine has no ROS; the port
    needs no cv_bridge). Yields a handle: `publishers` (each with its
    `published` messages), `subscribers` (topic, callback), `params` (the
    parameter server) and `sync` (the time synchronizer's callback)."""
    import types

    h = types.SimpleNamespace(publishers=[], subscribers=[], params=params, sync=None)

    class Publisher:
        def __init__(self, topic, msg_type, queue_size=10):
            self.topic, self.published = topic, []
            h.publishers.append(self)

        def publish(self, msg):
            self.published.append(msg)

    class Sync:
        def __init__(self, subs, queue_size=10, slop=0.1):
            self.subs = subs

        def registerCallback(self, cb):
            h.sync = cb

    mods = {n: types.ModuleType(n) for n in (
        "rospy", "sensor_msgs", "sensor_msgs.msg", "keypoint_msg", "keypoint_msg.msg",
        "object_msgs", "object_msgs.msg", "message_filters")}
    mods["rospy"].Publisher = Publisher
    mods["rospy"].Subscriber = lambda topic, msg_type, cb: h.subscribers.append((topic, cb))
    mods["rospy"].get_param = lambda name, default=None: h.params.get(name, default)
    mods["rospy"].init_node = lambda name: None
    mods["sensor_msgs.msg"].Image = RosBag
    mods["keypoint_msg.msg"].KeypointArray = RosBag
    mods["object_msgs.msg"].ObjectInstance2DArray = lambda: RosBag(instances=[])
    mods["object_msgs.msg"].ObjectInstance2D = RosBag
    mods["message_filters"].Subscriber = lambda topic, msg_type: topic
    mods["message_filters"].ApproximateTimeSynchronizer = Sync
    for pkg in ("sensor_msgs", "keypoint_msg", "object_msgs"):
        mods[pkg].msg = mods[f"{pkg}.msg"]
    saved = {n: sys.modules.get(n) for n in mods}
    sys.modules.update(mods)
    try:
        yield h
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def launch_yolocfg(weights: Path) -> dict:
    """The `yolocfg` of the port's `yolopoint.launch`, its `$(arg ...)`
    substituted (`weights` the given file, the others their defaults), read
    without ROS: the `key: value` lines of its `<rosparam>` block, numbers
    as numbers."""
    import xml.etree.ElementTree as ET

    root = ET.parse(REPO / ROS_LAUNCH).getroot()
    args = {a.get("name"): a.get("default") for a in root.iter("arg")}
    args["weights"] = str(weights)
    text = re.sub(r"\$\(arg (\w+)\)", lambda m: args[m.group(1)],
                  root.find(".//rosparam").text)
    cfg = {}
    for line in text.splitlines():
        key, _, value = line.strip().partition(":")
        value = value.strip()
        if not value:
            continue  # the `yolocfg:` key itself
        for kind in (int, float):
            try:
                value = kind(value)
                break
            except ValueError:
                pass
        cfg[key] = value
    return cfg


def ros_image(img: np.ndarray, encoding: str, frame_id: str, seq: int) -> RosBag:
    """A `sensor_msgs/Image` of a BGR frame in `encoding` (mono8: its green
    plane; bgra8: rows padded by `ROS_ROW_PAD` bytes)."""
    H, W = img.shape[:2]
    px = {"bgr8": img, "rgb8": img[..., ::-1], "mono8": img[..., 1:2],
          "bgra8": np.concatenate([img, np.full((H, W, 1), 255, np.uint8)], 2)}[encoding]
    rows = np.ascontiguousarray(px).reshape(H, -1)
    pad = ROS_ROW_PAD if encoding == "bgra8" else 0
    data = np.concatenate([rows, np.zeros((H, pad), np.uint8)], 1).tobytes()
    return RosBag(header=RosBag(frame_id=frame_id, seq=seq, stamp=0.1 * seq), height=H, width=W,
                  encoding=encoding, step=rows.shape[1] + pad, is_bigendian=0, data=data)


@torch.inference_mode()
def ros_phase(seed: int, device: str = "cuda"):
    """The ROS node of the port's launch file on the card (see the module
    docstring, `ros`). Returns the phase line and the launches of the timed
    callbacks."""
    from yolopoint_tpu_torch.data.png import write_png
    from yolopoint_tpu_torch.deploy import image_msg, ros_node, ros_param_node
    from yolopoint_tpu_torch.deploy.ros_listener import KeypointListener
    from yolopoint_tpu_torch.frontend.pipeline import preprocess_frame
    from yolopoint_tpu_torch.ops import _build

    H, W = ROS_FRAME
    names = [f"c{i}" for i in range(80)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        weights = tmp / "yolopoint_s.pt"
        save_reference_weights(weights, seed, version="s", names=names,
                               detect_bias=DEMO_DETECT_BIAS)
        bonnet = np.zeros((H, W), np.uint8)
        bonnet[540:, 160:1120] = 255  # the ego vehicle's bonnet in camera cam0
        write_png(tmp / "cam0_bonnet.png", bonnet)
        cfg = launch_yolocfg(weights)
        lowered = [cfg["detection_threshold"], SERVE_THRESHOLD]
        cfg["detection_threshold"] = SERVE_THRESHOLD
        cfg["template"] = {"cam0": str(tmp / "cam0_bonnet.png")}
        kinds = image_kind_files(seed + 30, H, W, set(ROS_TEMPLATE_KINDS.values()))
        for cam, name in ROS_TEMPLATE_KINDS.items():  # lossless JPEG, PBM, a None kind, TIFF
            (tmp / name).write_bytes(kinds[name])
            cfg["template"][cam] = str(tmp / name)
        frames = panning_frames(seed + 20, ROS_FRAMES + 2, H, W, step=4)
        msgs = [ros_image(f, ROS_ENCODINGS.get(i, "bgr8"), ("cam0", "cam1")[i % 2], i)
                for i, f in enumerate(frames[2:])]
        for i, (m, f) in enumerate(zip(msgs, frames[2:])):  # the decode of each encoding
            want = np.repeat(f[..., 1:2], 3, 2) if m.encoding == "mono8" else f
            if not np.array_equal(image_msg.imgmsg_to_bgr8(m), want):
                raise AssertionError(f"ros: the {m.encoding} message {i} decodes to another image")
        with fake_ros({"~yolocfg": cfg}) as ros:
            t0 = time.perf_counter()
            node = ros_param_node.build_node(device=device)
            build_s = time.perf_counter() - t0
            if set(node.templates) != {"cam0", "cam2", "cam3", "cam5"}:
                raise AssertionError(f"ros: templates {sorted(node.templates)} loaded, want cam0, "
                                     "cam2 (lossless JPEG), cam3 (PBM), cam5 (16-bit grey "
                                     "TIFF); cam4's file reads None")
            callback = ros.subscribers[-1][1]
            raws, forward = [], node.pipeline.forward

            def recording(images):  # the raw outputs of each frame, for the CPU decode
                out = forward(images)
                raws.append(out)
                return out

            node.pipeline.forward = recording
            for f in frames[:2]:  # warm-up
                callback(ros_image(f, "bgr8", "cam1", -1))
            torch.cuda.synchronize()
            raws.clear()
            kp_pub, obj_pub = ros.publishers[:2]
            kp_pub.published.clear()
            obj_pub.published.clear()
            _build.launch_counts.clear()
            times, phases = [], []
            for m in msgs:
                t0 = time.perf_counter()
                callback(m)
                times.append((time.perf_counter() - t0) * 1e3)
                phases.append(node.last_timing)
            launches = dict(_build.launch_counts)
            for k in ROS_KERNELS:
                if launches.get(k, 0) != ROS_FRAMES:
                    raise AssertionError(f"ros: launches {launches}, want {ROS_FRAMES} of {k}")
            kp_msgs, obj_msgs = kp_pub.published, obj_pub.published
            if len(kp_msgs) != ROS_FRAMES or len(obj_msgs) != ROS_FRAMES:
                raise AssertionError(f"ros: published {len(kp_msgs)} / {len(obj_msgs)} messages")
            mask = node.templates["cam0"]
            for m, k in zip(msgs, kp_msgs):
                x, y = np.asarray(k.x, np.int64), np.asarray(k.y, np.int64)
                if k.header.frame_id != m.header.frame_id or not len(x):
                    raise AssertionError(f"ros: message of {m.header.frame_id}: {len(x)} points")
                if (x >= W).any() or (y >= H).any():
                    raise AssertionError("ros: a published keypoint lies off the frame")
                if m.header.frame_id == "cam0" and mask[y, x].any():
                    raise AssertionError("ros: a keypoint was published on the eroded template")

            # the card's messages against the CPU decode of the same raw outputs,
            # through the same node code on the CPU
            class Replay:
                def __init__(self):
                    self.outs = []

                def process_frame(self, img, img_size=None):
                    return self.outs.pop(0)

            replay = Replay()
            cpu_node = ros_node.YoloPointRosNode(replay, names, "cpu_replay", cfg["img_size"],
                                                 cfg["template"], device="cpu")
            cpu_cb = ros.subscribers[-1][1]
            for cam, mask_card in node.templates.items():
                if not np.array_equal(mask_card, cpu_node.templates[cam]):
                    raise AssertionError(f"ros: the {cam} template's mask differs from the CPU's")
            checks, suppressed = [], 0
            for m, raw in zip(msgs, raws):
                g, c = decode_both(node.pipeline, raw)
                checks.append(compare_decodes(g, c, "ros"))
                _, (top, left), ratio = preprocess_frame(image_msg.imgmsg_to_bgr8(m),
                                                         cfg["img_size"])
                out = {k: v[0] for k, v in c.items()}
                out["keypoints"] = (out["keypoints"] + np.array([left, top])) / ratio
                out["boxes"] = (out["boxes"] + np.array([left, top, left, top])) / ratio
                if m.header.frame_id == "cam0":
                    kp = out["keypoints"][out["kp_valid"]].astype(int)
                    suppressed += int(mask[kp[:, 1].clip(0, H - 1), kp[:, 0].clip(0, W - 1)]
                                      .sum())
                replay.outs.append(out)
                cpu_cb(m)
            cpu_kp, cpu_obj = ros.publishers[2].published, ros.publishers[3].published
            desc_err, box_err = 0.0, 0
            for i, (a, b, oa, ob) in enumerate(zip(kp_msgs, cpu_kp, obj_msgs, cpu_obj)):
                if not (np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)
                        and np.array_equal(a.score, b.score)
                        and int(a.desc_len) == int(b.desc_len)):
                    raise AssertionError(f"ros: frame {i}: the card's keypoints differ from "
                                         "the CPU's")
                desc_err = max(desc_err, float(np.abs(a.desc_flat - b.desc_flat).max()))
                ia = sorted((q.class_index, q.bounding_box_min_x, q.bounding_box_min_y,
                             q.bounding_box_max_x, q.bounding_box_max_y) for q in oa.instances)
                ib = sorted((q.class_index, q.bounding_box_min_x, q.bounding_box_min_y,
                             q.bounding_box_max_x, q.bounding_box_max_y) for q in ob.instances)
                if len(ia) != len(ib) or any(p[0] != q[0] for p, q in zip(ia, ib)):
                    raise AssertionError(f"ros: frame {i}: instances {ia} vs {ib}")
                box_err = max([box_err] + [abs(u - v) for p, q in zip(ia, ib)
                                           for u, v in zip(p[1:], q[1:])])
            if not desc_err <= 1e-5 or box_err > 1:
                raise AssertionError(f"ros: descriptors differ by {desc_err}, box corners by "
                                     f"{box_err} px")
            if not suppressed:
                raise AssertionError("ros: the template suppressed no keypoint")

            listener = KeypointListener("image_raw", show=False)
            for m, k in zip(msgs, kp_msgs):
                ros.sync(m, k)
            t0 = time.perf_counter()
            drawn = listener._draw(listener.last_image)
            draw_ms = (time.perf_counter() - t0) * 1e3
            tracks = listener.tracker.get_tracks(min_length=2)
            if not len(tracks) or drawn.shape != (H, W, 3):
                raise AssertionError(f"ros: the listener kept {len(tracks)} tracks")
    split = {k: statistics.median(p[k] for p in phases) for k in phases[0]}
    line = {"phase": "ros", "model": "YOLOPoint-s", "nc": 80, "launch_file": ROS_LAUNCH,
            "yolocfg": {k: v for k, v in cfg.items() if k not in ("weights", "template")},
            "lowered": {"detection_threshold": lowered}, "frame": list(ROS_FRAME),
            "frames": ROS_FRAMES, "encodings": [m.encoding for m in msgs],
            "build_node_s": build_s, "callback_ms_p50": statistics.median(times),
            "callback_ms_all": times, "split_ms_p50": split,
            "keypoints_per_frame": [len(k.x) for k in kp_msgs],
            "instances_per_frame": [len(o.instances) for o in obj_msgs],
            "template_suppressed": suppressed,
            "templates": {"loaded": sorted(node.templates), "files": ROS_TEMPLATE_KINDS,
                          "masks_equal_cpu": len(node.templates)},
            "card_vs_cpu": {"keypoints": [ck["keypoints"] for ck in checks],
                            "descriptor_max_abs": desc_err, "box_corner_max_px": box_err},
            "listener": {"tracks": int(len(tracks)), "draw_ms": draw_ms},
            "launches": launches, "host_code": ros_host_checks(seed)}
    return line, launches


def ros_host_checks(seed: int) -> dict:
    """The host code of this slice on the card's machine against its numpy
    twins: the covariance packing (`yp_cov_*`), the grey reads of PNG (every
    colour type, gAMA / sRGB, Adam7), BMP (24-bit and run-length) and PPM,
    Adam7 PNG and run-length BMP in colour, multi-scan JPEG written here;
    the JPEG fixtures of `tests/data/` decoded by the compiled decoder to
    the SHA-256 of `cv2.imread`'s pixels recorded beside them (colour and
    grey) and equal to the numpy twin; and the compiled decode times of the
    largest fixture, a 480x640 three-scan JPEG and a 375x1242 Adam7 PNG."""
    import hashlib
    import struct
    import zlib

    from yolopoint_tpu_torch.data import bmp, jpeg, native, png
    from yolopoint_tpu_torch.data.datasets import _imread
    from yolopoint_tpu_torch.deploy.messages import CovarianceHelper, Object3D

    rng = np.random.default_rng(seed)
    out = {}
    for n in (1, 6, 24):
        a = rng.normal(size=(n, n)).astype(np.float32)
        cov = a @ a.T
        packed = native.cov_pack_upper(cov)
        if not (np.array_equal(packed, native.cov_pack_upper(cov, "cpu")) and np.array_equal(
                native.cov_unpack_upper(packed, n), native.cov_unpack_upper(packed, n, "cpu"))):
            raise AssertionError(f"ros host: the compiled covariance packing differs at n = {n}")
        msg = CovarianceHelper.covariance_to_msg(cov, np.arange(24) < n, Object3D())
        if not np.array_equal(CovarianceHelper.covariance_from_msg(msg), cov):
            raise AssertionError("ros host: the covariance does not round-trip")
    out["covariance_sizes"] = [1, 6, 24]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind +
                                                                                    body))

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        files = []
        for color, depth in ((0, 16), (2, 8), (2, 16), (3, 4), (4, 8), (6, 8), (6, 16)):
            s = rng.integers(0, 2 ** depth, (23, 37, png.CHANNELS[color]))
            pal = rng.integers(0, 256, (2 ** depth, 3)) if color == 3 else None
            for interlace in (False, True):
                data = encode_png(s, color, depth, palette=pal, interlace=interlace)
                gammas = [b""] if depth == 16 and color in (2, 6) else \
                    [b"", chunk(b"gAMA", struct.pack(">I", 45455)), chunk(b"sRGB", b"\0")]
                for j, extra in enumerate(gammas):
                    at = data.index(b"PLTE" if color == 3 else b"IDAT") - 4
                    files.append(tmp / f"p{color}_{depth}_{interlace}_{j}.png")
                    files[-1].write_bytes(data[:at] + extra + data[at:])
        for i, bpp in enumerate((8, 4, 8, 4)):
            files.append(tmp / f"rle{i}.bmp")
            files[-1].write_bytes(encode_bmp_rle(rng, 37 + i, 23 + i, bpp))
        img = smooth_frame(rng, 24, 40)
        write_ppm(tmp / "f.ppm", img)
        files.append(tmp / "f.ppm")
        for k, scans in enumerate((((0,), (1,), (2,)), ((0,), (1, 2)))):
            files.append(tmp / f"multiscan{k}.jpg")
            files[-1].write_bytes(encode_jpeg(smooth_frame(rng, 40, 56), 90, "420", k, scans=scans))
        for path in files:
            for channels in (3, 1):
                if not np.array_equal(_imread(str(path), "cuda", channels),
                                      _imread(str(path), "cpu", channels)):
                    raise AssertionError(f"ros host: the compiled read of {path.name} "
                                         f"({channels} channel) differs from numpy's")
        out["files_checked"] = len(files)

    index = json.loads((REPO / "tests" / "data" / "jpeg_fixtures.json").read_text())
    for name, entry in index["files"].items():
        data = (REPO / "tests" / "data" / name).read_bytes()
        for grey, key in ((False, "colour_sha256"), (True, "grey_sha256")):
            got = jpeg.decode_jpeg(data, name, grey=grey)
            if hashlib.sha256(got.tobytes()).hexdigest() != entry[key]:
                raise AssertionError(f"ros host: {name} ({key[:-7]}) is not cv2's pixels")
            if not np.array_equal(got, jpeg.decode_jpeg(data, name, "cpu", grey)):
                raise AssertionError(f"ros host: {name} decodes otherwise in numpy")
    out["jpeg_fixtures_equal_cv2"] = len(index["files"])

    def p50(fn, n=7):
        return statistics.median(_timed_ms(fn) for _ in range(n))

    largest = max(index["files"], key=lambda n: index["files"][n]["bytes"])
    data = (REPO / "tests" / "data" / largest).read_bytes()
    multi = encode_jpeg(kitti_frame(rng, *COCO_SIZE), COCO_QUALITY, "420",
                        scans=((0,), (1,), (2,)))
    frame = kitti_frame(rng)
    adam7 = encode_png(frame[..., ::-1], 2, interlace=True)
    if not np.array_equal(png.decode_png(adam7), frame):
        raise AssertionError("ros host: the Adam7 frame does not decode to what was written")
    out["decode_ms_p50"] = {
        largest: p50(lambda: jpeg.decode_jpeg(data)),
        "multiscan_480x640": p50(lambda: jpeg.decode_jpeg(multi)),
        "multiscan_480x640_grey": p50(lambda: jpeg.decode_jpeg(multi, grey=True)),
        "adam7_png_375x1242": p50(lambda: png.decode_png(adam7)),
        "adam7_png_375x1242_grey": p50(lambda: png.decode_png(adam7, grey=True))}
    if bmp.decode_bmp(encode_bmp_rle(rng, 64, 48, 8)).shape != (48, 64, 3):
        raise AssertionError("ros host: a run-length BMP decodes to another shape")
    return out


# ---------------------------------------------------------------- the bootstrap chain

BOOTSTRAP_CONFIGS = {  # the configs the JAX synth_r5 run used (tools/bootstrap.py's stages)
    "config": "configs/synthetic_r5.yaml", "export_config": "configs/synthetic_export.yaml",
    "pseudo_config": "configs/synthetic_pseudo.yaml"}
BOOTSTRAP_CUT = {  # the smoke phase's cut: images and epochs only (the pseudo lengths
    # must equal the export's, so its images meet their labels)
    "config": {"data": {"length": {"train": 64, "val": 16}}, "training_params": {"epochs": 2}},
    "export_config": {"data": {"length": {"train": 16}}},
    "pseudo_config": {"data": {"length": {"train": 16, "val": 16}},
                      "training_params": {"epochs": 1}},
}
BOOTSTRAP_SCENES = 2  # viewpoint scenes of the HPatches twin for the smoke phase
# SHA-256 of the first scene the JAX package's tool writes,
# `python tools/make_synthetic_hpatches.py --hw 256 320` (seed 3, cv2 5.0.0):
# the port's twin must write these bytes
HPATCHES_SYNTH_SHA256 = {
    "1.ppm": "9938389d075b715812aefa9e4bf2046f26bed081faf3ba7b65f81da7d6e4073c",
    "2.ppm": "627a014938ecb3774319a163e6a4626279e3b03f6165f1aad464b2235f85a9ae",
    "3.ppm": "c46c5aa35bde98370f35e986c2da9d7c59f4b35bbf3d03b8f1dce9308c88b307",
    "4.ppm": "f5410cae5fe3002a15b0bd9dc111e24d7c4d699e161c546fc4507354747228fd",
    "5.ppm": "a0e6c3b767ca633d09ddf152b16163e5d4914c58c8727e5c537a68930c174cbe",
    "6.ppm": "cc3c2ae5fac8770203d58c3e3f6185b13de1f10e55fbef64d8d6ebf8a35c5cda",
    "H_1_2": "6fe9dc8f22dafb0f4eac1b8e0b0a0e873354e5829739667fd18fddd810927035",
    "H_1_3": "635d0fa0849b3fbedf4ebf4c78c031915316ef25bbb62c2c291a3849b1773312",
    "H_1_4": "55b71a452c9f781f4047a8f6f1241388308680f8214f2befe645edcac976d859",
    "H_1_5": "625372b19ca1d32db9eef03cd5961332b262890723165de79c7f873f9a04b9e8",
    "H_1_6": "4cc9efe0a647ac2136f7f0cf34f18139e7b9ff9beaa0a8848e55c4c478fb0868",
}
HPATCHES_KEYS = {"repeatability", "localization_error", "matching_score", "match_mAP",
                 "correctness@1", "correctness@3", "correctness@5", "correctness@10",
                 "correctness@20", "correctness@50", "num_pairs"}


def cv_warp_reference(seed: int) -> dict:
    """OpenCV's 8-bit warps (`data/cv_warp.py`) in compiled host code against
    their numpy versions, byte for byte: `warpPerspective` (bilinear,
    constant border) of (480, 640, 3) into (240, 320) and of odd sizes with
    1 and 4 channels, zoom-outs and rotations; `warpAffine` (inverse map,
    nearest, reflected) at the sequence tool's sizes and odd ones; then
    `tools.synthetic_sequence` with `--device cuda` against `--device cpu`
    (4 frames, the files byte-equal). Times a 240x320 call of each form."""
    from yolopoint_tpu_torch.data import cv_warp
    from yolopoint_tpu_torch.tools import synthetic_sequence

    rng = np.random.default_rng(seed)
    cases = 0
    for k in range(12):
        (sh, sw), (H, W), C = [((480, 640), (240, 320), 3), ((37, 53), (23, 37), 1),
                               ((101, 77), (57, 101), 4), ((512, 640), (256, 320), 1)][k % 4]
        src = rng.integers(0, 256, (sh, sw, C), np.uint8)
        ang, s = rng.uniform(-np.pi, np.pi), rng.uniform(0.3, 3.0)
        M = np.array([[s * np.cos(ang), -s * np.sin(ang), rng.uniform(-sw, sw)],
                      [s * np.sin(ang), s * np.cos(ang), rng.uniform(-sh, sh)],
                      [rng.normal(0, 1e-3), rng.normal(0, 1e-3), 1.0]])
        for fn in ("perspective", "affine"):
            arg = M if fn == "perspective" else M[:2]
            got = getattr(cv_warp.COMPILED_CV_WARP, fn)(src, arg, (W, H))
            want = getattr(cv_warp.NUMPY_CV_WARP, fn)(src, arg, (W, H))
            if not np.array_equal(got, want):
                raise AssertionError(f"cv_warp {fn} {src.shape} -> {(H, W)}: "
                                     f"{int((got != want).sum())} bytes differ from numpy")
            cases += 1
    src = rng.integers(0, 256, (480, 640, 3), np.uint8)
    M = np.array([[0.9, 0.1, 100.0], [-0.1, 1.1, 60.0], [1e-4, 2e-4, 1.0]])
    ms = {f"{fn}_{form.name}": min(_timed_ms(lambda: getattr(form, fn)(src, M if fn ==
                                                                       "perspective" else M[:2],
                                                                       (320, 240)))
                                   for _ in range(3))
          for fn in ("perspective", "affine")
          for form in (cv_warp.COMPILED_CV_WARP, cv_warp.NUMPY_CV_WARP)}
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(sys.stderr):
        tmp = Path(tmp)
        for dev in ("cuda", "cpu"):
            synthetic_sequence.main(["--out", str(tmp / dev), "--frames", "4", "--device", dev])
        frames = sorted(p.name for p in (tmp / "cuda").iterdir())
        same = [(tmp / "cuda" / f).read_bytes() == (tmp / "cpu" / f).read_bytes() for f in frames]
    if len(frames) != 4 or not all(same):
        raise AssertionError(f"synthetic_sequence: card and CPU frames differ ({same})")
    return {"phase": "cv_warp", "cases": cases, "equal": True, "ms": ms,
            "sequence_frames_equal": len(frames)}


def render_hpatches_twin(root: Path, scenes: int, i_scenes: int, device: str = "cuda") -> dict:
    """`tools.synthetic_hpatches` (the JAX tool's twin) at `HPATCHES_SIZE`,
    seed 3, into `root`; checks its first scene against the JAX tool's
    SHA-256 (`HPATCHES_SYNTH_SHA256`). Returns the seconds and the files that
    differ (none, or it raises)."""
    import hashlib

    from yolopoint_tpu_torch.tools import synthetic_hpatches

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        synthetic_hpatches.main(["--out", str(root), "--hw", *map(str, HPATCHES_SIZE),
                                 "--scenes", str(scenes), "--i-scenes", str(i_scenes),
                                 "--device", device])
    seconds = time.perf_counter() - t0
    scene = root / "v_synth000"
    differ = [f for f, h in HPATCHES_SYNTH_SHA256.items()
              if hashlib.sha256((scene / f).read_bytes()).hexdigest() != h]
    if differ:
        raise AssertionError(f"hpatches twin: {differ} differ from the JAX tool's files")
    return {"seconds": seconds, "scenes": scenes + i_scenes,
            "checked_files": len(HPATCHES_SYNTH_SHA256)}


def stage_name(cmd) -> str:
    """The bootstrap stage of a `python -m <module> ...` command."""
    module = cmd[cmd.index("-m") + 1]
    if module.endswith("training.cli"):
        return "retrain" if "--pretrained" in cmd else "pretrain"
    if module.endswith("export.cli"):
        return "export"
    if module.endswith("hpatches_runner"):
        return "hpatches_" + Path(cmd[cmd.index("--weights") + 1]).name
    return "summary"


@contextlib.contextmanager
def kernel_input_probes():
    """While active, the first input of each shape and dtype of K1
    (`cuda_nms.nms_tile_keys`), K3 (`cuda_gather.sample_descriptors_cuda`)
    and the warp (`cuda_warp.warp_image_cuda`), and every K2 input
    (`cuda_box_nms.greedy_nms_keep`: the tiles), recorded from the calls the
    torch.library ops make. Yields the dict they fill."""
    from yolopoint_tpu_torch.ops import cuda_box_nms, cuda_gather, cuda_nms, cuda_warp

    rec = {"k1": {}, "k3": {}, "warp": {}, "tiles": []}
    real = {(cuda_nms, "nms_tile_keys"): cuda_nms.nms_tile_keys,
            (cuda_gather, "sample_descriptors_cuda"): cuda_gather.sample_descriptors_cuda,
            (cuda_warp, "warp_image_cuda"): cuda_warp.warp_image_cuda,
            (cuda_box_nms, "greedy_nms_keep"): cuda_box_nms.greedy_nms_keep}

    def k1(heatmap, conf, radius, iterations=3, border=4, tile=None):
        rec["k1"].setdefault((tuple(heatmap.shape), heatmap.dtype),
                             (heatmap.clone(), float(conf), int(radius), int(iterations),
                              int(border), tile))
        return real[(cuda_nms, "nms_tile_keys")](heatmap, conf, radius, iterations, border, tile)

    def k3(desc, points, cell_size=8):
        rec["k3"].setdefault((tuple(desc.shape), tuple(points.shape), desc.dtype),
                             (desc.clone(), points.clone(), int(cell_size)))
        return real[(cuda_gather, "sample_descriptors_cuda")](desc, points, cell_size)

    def warp(img, homography_inv, mode="bilinear"):
        rec["warp"].setdefault((tuple(img.shape), mode),
                               (img.clone(), homography_inv.clone(), mode))
        return real[(cuda_warp, "warp_image_cuda")](img, homography_inv, mode)

    def k2(boxes, valid, iou_thres):
        rec["tiles"].append((boxes.clone(), valid.clone(), float(iou_thres)))
        return real[(cuda_box_nms, "greedy_nms_keep")](boxes, valid, iou_thres)

    for (owner, name), fn in zip(real, (k1, k3, warp, k2)):
        setattr(owner, name, fn)
    try:
        yield rec
    finally:
        for (owner, name), fn in real.items():
            setattr(owner, name, fn)


def trained_val_kernels(run_dir: Path, device: str = "cuda") -> list:
    """K1, K2 and K3 on the inputs that one `TrainAgent.validate` batch gives
    them with a run's weights: the run's `config.yml`, its `best.pt` (the EMA
    shadow, `pretrained`), the first batch of the CLI's val loader. Each
    held against its plain version (`check_k1_on`, `check_k2_tiles`,
    `check_k3_on`); returns their kernel lines."""
    from yolopoint_tpu_torch.data.datasets import build_dataset
    from yolopoint_tpu_torch.data.loader import DataLoader
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.training.cli import warp_path
    from yolopoint_tpu_torch.utils.config import load_config

    cfg = load_config(run_dir / "config.yml")
    cfg.pop("resume", None)
    cfg["pretrained"] = str(run_dir)
    data, tp = cfg["data"], cfg.get("training_params", {})
    aug = data.get("augmentation") or {}
    host_warp, _ = warp_path(aug, torch.device(device))
    val_aug = data.get("val_augmentation") or aug
    val_set = build_dataset(data, "val", cfg.get("names", []), "datasets", False, device)
    loader = DataLoader([val_set], int(tp.get("val_batch_size", 8)), shuffle=False, seed=0,
                        host_augment_config=val_aug if host_warp else None, device=device)
    batch = next(iter(loader))
    agent = step_agent(cfg, [batch], [batch], seed=0, device=device)
    with kernel_input_probes() as rec, contextlib.redirect_stdout(sys.stderr):
        scalars = agent.validate()
    torch.cuda.synchronize()
    del agent
    lines = []
    for (shape, _), (hm, conf, r, it, border, tile) in rec["k1"].items():
        before = sum(_build.launch_counts.values())
        line = check_k1_on(hm, conf, r, it, border, 10, tile)
        lines.append(dict(line, launches=sum(_build.launch_counts.values()) - before))
    before = sum(_build.launch_counts.values())
    line = check_k2_tiles(rec["tiles"])
    lines.append(dict(line, launches=sum(_build.launch_counts.values()) - before))
    for desc, pts, cell in rec["k3"].values():
        before = sum(_build.launch_counts.values())
        line = check_k3_on(desc, pts, cell, 10)
        lines.append(dict(line, launches=sum(_build.launch_counts.values()) - before))
    for line in lines:
        line.update(input=f"val batch of {run_dir.name}", val_fitness=scalars.get("fitness"))
    return lines


def bootstrap_configs(tmp: Path, cut: dict | None) -> list:
    """The chain's three configs written by `save_config` into `tmp` with
    `cut` merged (the pseudo config read raw, as `tools.bootstrap` reads it);
    returns the bootstrap flags naming them."""
    from yolopoint_tpu_torch.utils.config import dict_update, load_config, parse_yaml, save_config

    flags = []
    for key, rel in BOOTSTRAP_CONFIGS.items():
        cfg = (parse_yaml((REPO / rel).read_text()) if key == "pseudo_config"
               else load_config(REPO / rel))
        save_config(dict_update(cfg, (cut or {}).get(key, {})), tmp / Path(rel).name)
        flags += [f"--{key}", str(tmp / Path(rel).name)]
    return flags


def check_bootstrap_runs(runs: Path, run: str, n_export: int, pairs: int) -> dict:
    """The files of the chain's stages: both runs' `done.json` (or, for a
    stopped run, `best_meta.json`: a finite best fitness), `best.pt`,
    `metrics.jsonl` and `hpatches.json`
    (the runner's keys, `pairs` pairs), `n_export` pseudo-label files named
    as the dataset names its images, the stage-3 snapshot pointing at them,
    and the summary. Returns the figures."""
    from yolopoint_tpu_torch.utils.config import load_config

    out = {}
    for name in (run, f"{run}_pseudo"):
        d = runs / name
        missing = [f for f in ("best.pt", "best_meta.json", "metrics.jsonl", "config.yml",
                               "hpatches.json") if not (d / f).is_file()]
        if missing:
            raise AssertionError(f"bootstrap: {d} lacks {missing}")
        # a run stopped before its last epoch (`run_until`) has no done.json
        done = json.loads((d / ("done.json" if (d / "done.json").is_file()
                                else "best_meta.json")).read_text())
        done = {k: done[k] for k in ("global_step", "best_fitness") if k in done}
        hp = json.loads((d / "hpatches.json").read_text())
        if not math.isfinite(done["best_fitness"]) or done["best_fitness"] < 0:
            raise AssertionError(f"bootstrap: {name} best fitness {done['best_fitness']}")
        if set(hp) != HPATCHES_KEYS or hp["num_pairs"] != pairs or not all(
                math.isfinite(v) for v in hp.values()):
            raise AssertionError(f"bootstrap: {name} hpatches {hp}")
        out[name] = {"done": done, "hpatches": hp}
    files = sorted((runs / run / "export").glob("*.npz"))
    names = [f"synth_train_{i:06d}.npz" for i in range(n_export)]
    if [f.name for f in files] != names:
        raise AssertionError(f"bootstrap: {len(files)} export files, want {n_export}")
    pts = [np.load(f)["pts"] for f in files]
    if any(p.ndim != 2 or p.shape[1] != 3 or not np.isfinite(p).all() for p in pts):
        raise AssertionError("bootstrap: an export file holds malformed points")
    snap = load_config(runs / run / "pseudo_config.yml")
    if snap["data"]["generation"]["points_dir"] != str(runs / run / "export"):
        raise AssertionError(f"bootstrap: the stage-3 snapshot points at "
                             f"{snap['data']['generation']['points_dir']}")
    summary = json.loads((runs / "RESULTS_torch.json").read_text())
    if sorted(summary) != sorted(out) or any("hpatches" not in v for v in summary.values()):
        raise AssertionError(f"bootstrap: the summary holds {sorted(summary)}")
    counts = [len(p) for p in pts]
    out["export"] = {"files": len(files), "pts_per_image_mean": float(np.mean(counts)),
                     "pts_per_image_min": min(counts), "pts_per_image_max": max(counts)}
    return out


def bootstrap_phase(seed: int, device: str = "cuda"):
    """`tools.bootstrap` (the JAX `tools/bootstrap.py`'s twin) on synth_r5's
    configs cut in depth (`BOOTSTRAP_CUT`: 64 train and 16 val images and 2
    epochs, 16 exported images at the config's 50 homographies, 1 epoch of
    retraining) with HPatches on `BOOTSTRAP_SCENES` scenes that
    `tools.synthetic_hpatches` renders on the card (its first scene held to
    the JAX tool's SHA-256), each stage's CLI run in this process as `python
    -m` runs it, from a temporary directory. Checks every stage's files
    (`check_bootstrap_runs`) and each stage's launches: K1, K2, K3 and a
    warp in both trainings, 3 K5 (256x320: the JAX gate's resident warp) and
    1 K1 an exported image, 2 K1, K2 and K3 a pair in each HPatches run, no
    K6, and every homography (HPatches and the validations) by the compiled
    RANSAC. Then the inputs recorded from the stages: K1, K3 and the warps
    at each shape they took, and K1, K2 and K3 on one val batch of the
    retrained run (`trained_val_kernels`). Returns the phase line, the
    path's launches and the kernel lines."""
    import runpy

    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.tools import bootstrap

    stages, launches = {}, {}

    def run_here(cmd):
        name = stage_name(cmd)
        i = cmd.index("-m")
        old_argv = sys.argv
        sys.argv = [cmd[i + 1], *cmd[i + 2:]]
        before = dict(_build.launch_counts)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(sys.stderr):
                runpy.run_module(cmd[i + 1], run_name="__main__")
            torch.cuda.synchronize()
        finally:
            sys.argv = old_argv
        stages[name] = {"seconds": time.perf_counter() - t0, "launches": {
            k: n - before.get(k, 0) for k, n in _build.launch_counts.items()
            if n != before.get(k, 0)}}
        for k, n in stages[name]["launches"].items():
            launches[k] = launches.get(k, 0) + n

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        tmp = Path(tmp)
        flags = bootstrap_configs(tmp, BOOTSTRAP_CUT)
        render = render_hpatches_twin(tmp / "hpatches_synth", BOOTSTRAP_SCENES, 0, device)
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        with kernel_input_probes() as rec, host_split_probes() as probe:
            bootstrap.main(["--run", "synth_r5", "--runs_dir", str(tmp / "runs"),
                            "--hpatches_data", str(tmp / "hpatches_synth"),
                            "--device", device, *flags], run=run_here)
        wall = time.perf_counter() - t0
        pairs = 5 * BOOTSTRAP_SCENES
        n_export = BOOTSTRAP_CUT["export_config"]["data"]["length"]["train"]
        figures = check_bootstrap_runs(tmp / "runs", "synth_r5", n_export, pairs)
        trained = trained_val_kernels(tmp / "runs" / "synth_r5_pseudo", device)
    want = {"export": {"K5": 3 * n_export, "nms_tile_keys": n_export}}
    for name in ("hpatches_synth_r5", "hpatches_synth_r5_pseudo"):
        want[name] = {k: 2 * pairs for k in ("nms_tile_keys", "greedy_nms_keep",
                                             "sample_descriptors")}
    for name, expect in want.items():
        if stages[name]["launches"] != expect:
            raise AssertionError(f"bootstrap {name}: launches {stages[name]['launches']}, "
                                 f"want {expect}")
    for name in ("pretrain", "retrain"):
        got = stages[name]["launches"]
        if not all(got.get(k) for k in ("nms_tile_keys", "greedy_nms_keep",
                                        "sample_descriptors")) \
                or not (got.get("K4") or got.get("K5")) or got.get("K6"):
            raise AssertionError(f"bootstrap {name}: launches {got}")
    lines = []
    for (shape, _), (hm, conf, r, it, border, tile) in rec["k1"].items():
        lines.append(check_k1_on(hm, conf, r, it, border, 10, tile))
    for desc, pts, cell in rec["k3"].values():
        lines.append(check_k3_on(desc, pts, cell, 10))
    for img, hom, mode in rec["warp"].values():
        lines.append(check_warp_on(img, hom, mode, 10, "recorded"))
    for line in lines:
        line["input"] = "recorded in the chain"
    if probe["compiled_calls"] <= 0:
        raise AssertionError("bootstrap: no homography was estimated")
    return {"phase": "bootstrap", "model": "YOLOPoint-n", "input": [256, 320],
            "configs": BOOTSTRAP_CONFIGS, "cut": BOOTSTRAP_CUT, "hpatches_render": render,
            "wall_s": wall, "stages": stages, "runs": figures,
            "ransac": "compiled (cv2.findHomography's)", "ransac_calls": probe["compiled_calls"],
            "launches": launches}, launches, lines + trained


def reference_weights_file(run_dir: Path, dest: Path) -> None:
    """A run's `best.pt` (the EMA shadow) saved as a reference-schema file,
    the form both packages read."""
    from yolopoint_tpu_torch.models.convert import load_weights, state_dict_to_reference

    loaded = load_weights(run_dir)
    meta = {k: loaded["meta"][k] for k in ("names", "version", "model_name")}
    torch.save({"model_state_dict": state_dict_to_reference(loaded["state_dict"]), **meta}, dest)


def run_until(cmd, log: Path, run_dir: Path, budget_s: float) -> int | None:
    """Run a training stage's command in a subprocess (its output to `log`)
    and stop it after the validation whose next round would end past
    `budget_s` seconds: once that validation's checkpoint (`meta_<epoch>.json`
    with its global step) is written, the process is terminated. The run
    keeps `best.pt` and `best_meta.json`, which `tools.bootstrap` takes as a
    finished stage. Returns the global step it was stopped after (None: it
    finished)."""
    t0 = time.perf_counter()
    seen, stop_at = [], None
    with open(log, "w") as f:
        proc = subprocess.Popen(list(cmd), cwd=REPO, stdout=f, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None:
                time.sleep(5)
                metrics = run_dir / "metrics.jsonl"
                if stop_at is None and metrics.exists():
                    vals = [json.loads(line)["step"] for line in metrics.read_text().splitlines()
                            if '"validation/fitness"' in line]
                    for step in vals[len(seen):]:
                        seen.append((step, time.perf_counter() - t0))
                    if len(seen) >= 2:
                        elapsed, last = seen[-1][1], seen[-1][1] - seen[-2][1]
                        if elapsed + last > budget_s:
                            stop_at = seen[-1][0]
                if stop_at is not None and any(
                        json.loads(m.read_text()).get("global_step") == stop_at
                        for m in run_dir.glob("meta_*.json")):
                    time.sleep(15)  # the best checkpoint follows its meta file
                    proc.terminate()
                    proc.wait(timeout=120)
                    return stop_at
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if proc.returncode:
        raise subprocess.CalledProcessError(proc.returncode, cmd)
    return None


def bootstrap_chain(out: Path, stage1_budget_s: float) -> int:
    """`python3 chip_smoke.py --bootstrap-chain OUT [STAGE1_SECONDS]`: the
    whole chain at the JAX synth_r5 run's configs. Renders the HPatches set
    with `tools.synthetic_hpatches --hw 256 320` (the size of the JAX run's
    set; its first scene held to the JAX tool's SHA-256) into `runs/`, runs
    `tools.bootstrap --run synth_r5 --config configs/synthetic_r5.yaml --fresh`
    (default export and pseudo configs; each stage a subprocess, its log in
    `OUT`), stage 1 stopped after the validation whose next round would pass
    `STAGE1_SECONDS` (`run_until`; its 32-epoch schedule unchanged), then K1,
    K2 and K3 on one val batch of the retrained model (`trained_val_kernels`).
    Writes to `OUT` the stage logs, both runs' small files and their weights
    as reference-schema files, and prints a JSON line: stage seconds, the
    step stage 1 stopped at, the runs' figures, the export's points an image,
    ms a micro-step (the epochs' `epoch_timing` lines), the kernel lines;
    then the card's name and power limit."""
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.tools import bootstrap
    from yolopoint_tpu_torch.utils.config import load_config

    out.mkdir(parents=True, exist_ok=True)
    runs = REPO / "runs"
    t_start = time.perf_counter()
    _build.build()
    _build.library()
    smi = nvidia_smi()
    render = render_hpatches_twin(runs / "hpatches_synth", 16, 8)
    stopped = {}

    def run_logged(cmd):
        name = stage_name(cmd)
        print(f"[bootstrap] $ {' '.join(cmd)}", flush=True)
        if name == "pretrain":
            stopped["step"] = run_until(cmd, out / f"{name}.log", runs / "synth_r5",
                                        stage1_budget_s)
            return
        with open(out / f"{name}.log", "w") as log:
            subprocess.run(list(cmd), cwd=REPO, stdout=log, stderr=subprocess.STDOUT, check=True)

    seconds = bootstrap.main(["--run", "synth_r5", "--config", BOOTSTRAP_CONFIGS["config"],
                              "--runs_dir", str(runs), "--hpatches_data",
                              str(runs / "hpatches_synth"), "--fresh"], run=run_logged)
    n_export = load_config(REPO / BOOTSTRAP_CONFIGS["export_config"])["data"]["length"]["train"]
    step_ms = {}
    for name in ("pretrain", "retrain"):
        epochs_seen = log_records((out / f"{name}.log").read_text(), "epoch_timing")
        per_step = [1e3 * e["train_s"] / e["micro_steps"] for e in epochs_seen if e["micro_steps"]]
        step_ms[name] = {"epochs": len(epochs_seen), "ms_per_micro_step_p50":
                         statistics.median(per_step), "ms_per_micro_step_all": per_step,
                         "loader_wait_s": [e["loader_wait_s"] for e in epochs_seen],
                         "val_s": [e["val_s"] for e in epochs_seen]}
    for name in ("synth_r5", "synth_r5_pseudo"):
        d = runs / name
        for f in ("done.json", "best_meta.json", "metrics.jsonl", "config.yml", "hpatches.json",
                  "pseudo_config.yml"):
            if (d / f).is_file():
                shutil.copy(d / f, out / f"{name}.{f}")
        reference_weights_file(d, out / f"{name}.pt")
    shutil.copy(runs / "RESULTS_torch.json", out / "RESULTS_torch.json")
    emit({"phase": "bootstrap_chain_stages", "stage_seconds": seconds,
          "stage1_stopped_after_step": stopped.get("step"), "step_ms": step_ms,
          "hpatches_render": render, "card": smi})
    figures = check_bootstrap_runs(runs, "synth_r5", n_export, 120)
    _build.launch_counts.clear()
    kernels = trained_val_kernels(runs / "synth_r5_pseudo")
    emit({"phase": "bootstrap_chain", "configs": BOOTSTRAP_CONFIGS,
          "stage1_stopped_after_step": stopped.get("step"), "stage_seconds": seconds,
          "step_ms": step_ms, "runs": figures, "kernels": kernels,
          "wall_s": time.perf_counter() - t_start, "card": smi})
    print(smi, flush=True)
    return 0

def _timed_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------- JAX-trained weights

JAX_RUNS = ("synth_s640_pseudo2", "synth_r5_pseudo_ext")  # the YOLOPoint-S flagship, a -n
JAX_HPATCHES = REPO / "datasets" / "hpatches_synth"  # 24 sequences, 120 pairs, 256x320
JAX_DIGESTS = REPO / "tests" / "torch_orbax_digests.json"  # tools/make_orbax_digests.py
JAX_SERVE_BATCH, JAX_SERVE_REQUESTS = 16, 8
# The JAX package's runner on this repository's files and weights, on a CPU
# (x86-64, JAX_PLATFORMS=cpu) at 256x320 over the 120 pairs, cv2.findHomography
# for the homographies; "bf16" its default fused path, "f32" with --f32:
#   python -m yolopoint_tpu.evaluation.hpatches_runner \
#       --data datasets/hpatches_synth --weights artifacts/<run>/best [--f32]
JAX_CPU_HPATCHES = {
    "synth_s640_pseudo2": {
        "bf16": {
            "repeatability": 0.9025, "localization_error": 0.7009, "matching_score": 0.8031,
            "match_mAP": 0.989, "correctness@1": 0.4083, "correctness@3": 0.8083,
            "correctness@5": 0.925, "correctness@10": 0.975, "correctness@20": 0.9833,
            "correctness@50": 1.0,
        },
        "f32": {
            "repeatability": 0.9018, "localization_error": 0.7033, "matching_score": 0.8003,
            "match_mAP": 0.9881, "correctness@1": 0.3833, "correctness@3": 0.8083,
            "correctness@5": 0.9083, "correctness@10": 0.9583, "correctness@20": 0.9667,
            "correctness@50": 1.0,
        },
    },
    "synth_r5_pseudo_ext": {
        "bf16": {
            "repeatability": 0.8001, "localization_error": 0.8782, "matching_score": 0.7105,
            "match_mAP": 0.9778, "correctness@1": 0.275, "correctness@3": 0.4833,
            "correctness@5": 0.6, "correctness@10": 0.825, "correctness@20": 0.9083,
            "correctness@50": 0.95,
        },
        "f32": {
            "repeatability": 0.7975, "localization_error": 0.8815, "matching_score": 0.7048,
            "match_mAP": 0.97, "correctness@1": 0.2667, "correctness@3": 0.4583,
            "correctness@5": 0.5667, "correctness@10": 0.8083, "correctness@20": 0.9,
            "correctness@50": 0.9417,
        },
    },
}
# the port's metrics on the card against the JAX runner's of the same
# precision: repeatability within 0.01; each correctness@k within 2 pairs of
# 120 in f32, within 8 in bf16. cuDNN's and XLA:CPU's bf16 convolutions
# round apart, and the JAX runner's own bf16 sits up to 4 pairs from its f32
# (PERF.md, the checkpoint reader's findings): two bf16 paths each within 4
# pairs of one f32 result lie within 8 of each other
HPATCHES_GAPS = {"f32": {"repeatability": 0.01, "correctness": 2 / 120},
                 "bf16": {"repeatability": 0.01, "correctness": 8 / 120}}


def jax_weights_files() -> list:
    """The files the `jax_weights` phase reads; raises naming any that the
    checkout lacks (the copy to the card must hold them)."""
    need = [JAX_HPATCHES, JAX_DIGESTS]
    for run in JAX_RUNS:
        need += [REPO / "artifacts" / run / f for f in ("best", "best_meta.json", "hpatches.json")]
    missing = [str(p.relative_to(REPO)) for p in need if not p.exists()]
    if missing:
        raise FileNotFoundError(f"jax_weights: the checkout lacks {missing}")
    return need


@contextlib.contextmanager
def compiled_codec_only():
    """While active, the Python zstd decoder and CRC-32C raise (a card run
    must decode with the compiled host code) and the compiled calls are
    counted. Yields the counts."""
    from yolopoint_tpu_torch.utils import crc32c, zstd

    calls = {"zstd": 0, "crc32c": 0}
    real = {(zstd, "decompress_compiled"): zstd.decompress_compiled,
            (crc32c, "crc32c_compiled"): crc32c.crc32c_compiled,
            (zstd, "decompress"): zstd.decompress, (crc32c, "crc32c"): crc32c.crc32c}

    def counted(key, fn):
        def run(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return run

    def banned(*args, **kwargs):
        raise AssertionError("a card run took the Python zstd decoder or CRC-32C")

    patches = {(zstd, "decompress_compiled"): counted("zstd", zstd.decompress_compiled),
               (crc32c, "crc32c_compiled"): counted("crc32c", crc32c.crc32c_compiled),
               (zstd, "decompress"): banned, (crc32c, "crc32c"): banned}
    for (owner, name), fn in patches.items():
        setattr(owner, name, fn)
    try:
        yield calls
    finally:
        for (owner, name), fn in real.items():
            setattr(owner, name, fn)


def jax_weights_read(smi: str) -> dict:
    """Both checkpoints read by the compiled reader: every array (params, EMA,
    BN statistics, step) against the committed digests of orbax's restore,
    bit for bit, and the load a run takes (`models.convert.load_weights`:
    EMA and BN statistics to a state dict), each with MB read, seconds and
    MB/s. Then the compiled zstd and CRC-32C against the Python ones on the
    small arrays' frames (BN statistics, step) and on every manifest and
    B-tree node file."""
    from yolopoint_tpu_torch.models.convert import load_weights
    from yolopoint_tpu_torch.training import orbax_read
    from yolopoint_tpu_torch.utils import crc32c, zstd

    want = json.loads(JAX_DIGESTS.read_text())
    out = {"phase": "jax_weights_read", "card": smi, "runs": {}}
    for run in JAX_RUNS:
        best = REPO / "artifacts" / run / "best"
        codec = orbax_read.Codec(compiled=True)
        with compiled_codec_only() as calls:
            t0 = time.perf_counter()
            digests = orbax_read.array_digests(best, codec)
            all_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            state = load_weights(best.parent, device="cuda")["state_dict"]
            load_s = time.perf_counter() - t0
        bad = sorted(k for k in set(want[run]) | set(digests) if digests.get(k) != want[run].get(k))
        if bad:
            raise AssertionError(f"jax_weights {run}: {len(bad)} arrays differ from orbax's "
                                 f"restore: {bad[:5]}")
        py = orbax_read.OrbaxCheckpoint(best, orbax_read.Codec(compiled=False))
        cc = orbax_read.OrbaxCheckpoint(best, orbax_read.Codec(compiled=True))
        small = {"batch_stats": (py.subtree("batch_stats"), cc.subtree("batch_stats")),
                 "step": (py.array(("step",)), cc.array(("step",)))}
        for name, (a, b) in small.items():
            flat_a, flat_b = _flat_arrays(a), _flat_arrays(b)
            if flat_a.keys() != flat_b.keys() or any(
                    flat_a[k].dtype != flat_b[k].dtype or not np.array_equal(flat_a[k], flat_b[k])
                    for k in flat_a):
                raise AssertionError(f"jax_weights {run}: {name} differs, compiled vs Python")
        frames = [k for k in cc.store.list()
                  if (k.startswith(b"batch_stats.") and not k.endswith(b".zarray"))
                  or k == b"step/0"]
        for key in frames:
            raw = cc.store.read(key)
            if zstd.decompress(raw) != zstd.decompress_compiled(raw):
                raise AssertionError(f"jax_weights {run}: frame {key!r} decodes apart")
        nodes = [best / "manifest.ocdbt", *sorted((best / "d").iterdir())]
        nodes += [p / "manifest.ocdbt" for p in sorted(best.glob("ocdbt.process_*"))]
        for path in nodes:
            raw = path.read_bytes()
            stored = int.from_bytes(raw[-4:], "little")
            if not crc32c.crc32c(raw[:-4]) == crc32c.crc32c_compiled(raw[:-4]) == stored:
                raise AssertionError(f"jax_weights {run}: CRC-32C of {path.name} apart")
        mb_in, mb_out = codec.bytes_in / 1e6, codec.bytes_out / 1e6
        out["runs"][run] = {
            "arrays": len(digests), "arrays_equal_to_orbax": len(digests) - len(bad),
            "all_arrays": {"mb_read": mb_in, "mb_decoded": mb_out, "seconds": all_s,
                           "mb_per_s_read": mb_in / all_s, "mb_per_s_decoded": mb_out / all_s},
            "load_weights": {"tensors": len(state), "seconds": load_s,
                             "mb_decoded": sum(t.numel() * t.element_size()
                                               for t in state.values()) / 1e6},
            "compiled_calls": calls, "small_frames_checked": len(frames),
            "node_files_checked": len(nodes)}
    return out


def _flat_arrays(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in
                _flat_arrays(v, f"{prefix}{k}.").items()}
    return {prefix: tree}


def box_recall(out: dict, gt: list, thres: float = 0.5) -> dict:
    """Ground-truth boxes `(cls, cx, cy, w, h)` normalized to the 640 image
    that a valid detection of the same class covers at IoU >= `thres`, and
    the valid detections that cover one."""
    from yolopoint_tpu_torch.ops.boxes import box_iou

    hit = total = used = dets = 0
    for b, boxes in enumerate(gt):
        valid = out["box_valid"][b].cpu()
        det = out["boxes"][b].cpu().float()[valid]
        cls = out["box_classes"][b].cpu()[valid]
        dets += len(det)
        if not len(boxes):
            continue
        g = torch.from_numpy(boxes).float()
        xy = g[:, 1:3] * 640
        wh = g[:, 3:5] * 640
        gxyxy = torch.cat([xy - wh / 2, xy + wh / 2], 1)
        total += len(g)
        if not len(det):
            continue
        iou = box_iou(gxyxy, det)
        same = g[:, :1].long() == cls[None].long()
        ok = (iou >= thres) & same
        hit += int(ok.any(1).sum())
        used += int(ok.any(0).sum())
    return {"gt_boxes": total, "recall": hit / max(total, 1), "detections": dets,
            "precision": used / max(dets, 1)}


def jax_weights_serve(device: str = "cuda") -> tuple[dict, dict, list]:
    """The flagship served from its orbax directory as the JAX CLI serves it:
    `deploy_model` (BN folded, its config's bf16, the checkpoint's names and
    version) through `InferencePipeline` at the benchmark operating point,
    on `JAX_SERVE_BATCH` 640x640 images of its own validation split (the
    synthetic shapes renderer at its data config): a warm-up request whose
    K1, K2 and K3 inputs are recorded, then `JAX_SERVE_REQUESTS` timed ones
    with the launches counted from 0. Boxes and keypoints against the
    rendered labels (recall and precision at IoU 0.5); each kernel held
    against its plain version on the recorded inputs. Returns the line, the
    launches and the kernel lines."""
    from yolopoint_tpu_torch.data.synthetic import SyntheticShapes
    from yolopoint_tpu_torch.frontend.pipeline import InferencePipeline, deploy_model
    from yolopoint_tpu_torch.ops import _build

    run = REPO / "artifacts" / JAX_RUNS[0]
    meta = json.loads((run / "best_meta.json").read_text())
    t0 = time.perf_counter()
    with compiled_codec_only() if torch.device(device).type == "cuda" else \
            contextlib.nullcontext():
        model, dtype, names, nc = deploy_model(str(run), "YOLOPoint", "s", None, f32=False,
                                               device=device)
    load_s = time.perf_counter() - t0
    pipe = InferencePipeline(model, SERVE_CONFIG, compute_dtype=dtype, device=device)
    shapes = SyntheticShapes(meta["config"]["data"], "val", names)
    samples = [shapes.get(i) for i in range(JAX_SERVE_BATCH)]
    frames = torch.from_numpy(np.stack([s["image"] for s in samples]))
    with kernel_input_probes() as rec:
        pipe(frames)  # warm-up, its kernel inputs recorded
    if device != "cpu":
        torch.cuda.synchronize()
    _build.launch_counts.clear()
    times = []
    for _ in range(JAX_SERVE_REQUESTS):
        t0 = time.perf_counter()
        out = pipe(frames)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.launch_counts)
    for k in ("keypoints", "kp_scores", "boxes", "box_scores", "descriptors"):
        if not torch.isfinite(out[k].float()).all():
            raise AssertionError(f"jax_weights serve: {k} is not finite")
    boxes = box_recall(out, [s["boxes"] for s in samples])
    if boxes["recall"] < 0.5 or boxes["precision"] < 0.5:
        raise AssertionError(f"jax_weights serve: the trained model's boxes against the "
                             f"rendered labels: {boxes}")
    line = {"phase": "jax_weights_serve", "run": JAX_RUNS[0],
            "model": f"YOLOPoint-{meta['version']}",
            "nc": nc, "names": names, "dtype": str(dtype).split(".")[-1] + " (fused)",
            "input": [JAX_SERVE_BATCH, 640, 640], "config": SERVE_CONFIG,
            "load_weights_s": load_s, "ms_p50": statistics.median(times), "ms_all": times,
            "images_per_s": JAX_SERVE_BATCH * 1e3 / statistics.median(times),
            "keypoints_per_image": float(out["kp_valid"].sum(1).float().mean()),
            "boxes_per_image": float(out["box_valid"].sum(1).float().mean()),
            "boxes_against_labels": boxes, "launches": launches}
    for name in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors"):
        if launches.get(name, 0) != JAX_SERVE_REQUESTS:
            raise AssertionError(f"jax_weights serve: {name} launched {launches.get(name, 0)} "
                                 f"times in {JAX_SERVE_REQUESTS} requests")
    lines = []
    for hm, conf, r, it, border, tile in rec["k1"].values():
        before = sum(_build.launch_counts.values())
        lines.append(dict(check_k1_on(hm, conf, r, it, border, 40, tile),
                          launches=sum(_build.launch_counts.values()) - before))
    before = sum(_build.launch_counts.values())
    k2 = check_k2_tiles(rec["tiles"], reps=20)
    lines.append(dict(k2, launches=sum(_build.launch_counts.values()) - before))
    if not k2["tiles_with_valid"]:
        raise AssertionError("jax_weights serve: K2's tiles hold no valid box")
    for desc, pts, cell in rec["k3"].values():
        before = sum(_build.launch_counts.values())
        lines.append(dict(check_k3_on(desc, pts, cell, 40),
                          launches=sum(_build.launch_counts.values()) - before))
    for kline in lines:
        kline["input"] = f"the trained {JAX_RUNS[0]} serving batch"
    return line, launches, lines


def jax_weights_hpatches(run: str, smi: str, device: str = "cuda") -> tuple[dict, dict]:
    """`hpatches_runner.main` from the run's orbax directory over the
    committed `datasets/hpatches_synth` (256x320, all 120 pairs), on the
    CLI's default fused bf16 path and with `--f32`: every metric beside the
    run's committed `hpatches.json` and the JAX runner's CPU numbers of the
    same precision (`JAX_CPU_HPATCHES`), held to that precision's
    `HPATCHES_GAPS`. 2 launches a pair of K1, K2 and K3 on each path, the
    compiled RANSAC and the compiled checkpoint reader. Returns the line and
    the launches of the default path."""
    from yolopoint_tpu_torch.evaluation import hpatches_runner
    from yolopoint_tpu_torch.ops import _build

    card = device != "cpu"
    committed = json.loads((REPO / "artifacts" / run / "hpatches.json").read_text())
    line = {"phase": "jax_weights_hpatches", "run": run, "card": smi}
    launches = {}
    for prec in ("bf16", "f32"):
        argv = ["--data", str(JAX_HPATCHES), "--weights", str(REPO / "artifacts" / run)]
        argv += ["--f32"] if prec == "f32" else []
        argv += [] if card else ["--device", "cpu"]
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr), host_split_probes() as probe, \
                compiled_codec_only() if card else contextlib.nullcontext():
            metrics = hpatches_runner.main(argv)
        seconds = time.perf_counter() - t0
        launches[prec] = dict(_build.launch_counts)
        pairs = metrics["num_pairs"]
        jax_cpu = JAX_CPU_HPATCHES[run][prec]
        gaps = {k: metrics[k] - jax_cpu[k] for k in jax_cpu}
        line[prec] = {
            "pairs": pairs, "seconds": seconds, "ms_per_pair": seconds * 1e3 / max(pairs, 1),
            "metrics": {k: {"port": metrics[k], "jax_cpu": jax_cpu.get(k),
                            "committed": committed.get(k) if prec == "bf16" else None}
                        for k in metrics if k != "num_pairs"},
            "gaps_to_jax_cpu": gaps,
            "gaps_in_pairs": {k: round(g * pairs) for k, g in gaps.items()
                              if k.startswith("correctness@")},
            "ransac_calls": probe["compiled_calls"], "launches": launches[prec]}
        limit = HPATCHES_GAPS[prec]
        over = {k: g for k, g in gaps.items()
                if (k == "repeatability" and abs(g) > limit["repeatability"])
                or (k.startswith("correctness@") and abs(g) > limit["correctness"] + 1e-9)}
        if pairs != 120 or over:
            raise AssertionError(f"jax_weights hpatches {run} {prec}: {pairs} pairs, gaps over "
                                 f"the limits {over}: {json.dumps(line)}")
        if card:
            want = {k: 2 * pairs
                    for k in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors")}
            if {k: launches[prec].get(k, 0) for k in want} != want or \
                    launches[prec].get("K6", 0):
                raise AssertionError(f"jax_weights hpatches {run} {prec}: launches "
                                     f"{launches[prec]}, want {want}")
    return line, launches["bf16"]


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "nvidia-smi failed"


KERNELS = {  # launch-count key -> (kernel name, CUDA source, TPU kernel it replaces, path)
    "nms_tile_keys": ("nms_tile_keys", "yolopoint_tpu_torch/ops/csrc/nms_keys.cu",
                      "yolopoint_tpu/ops/pallas_nms.py:172", "serve"),
    "greedy_nms_keep": ("greedy_nms_keep", "yolopoint_tpu_torch/ops/csrc/box_nms.cu",
                        "yolopoint_tpu/ops/pallas_box_nms.py:30", "serve"),
    "sample_descriptors": ("sample_descriptors", "yolopoint_tpu_torch/ops/csrc/gather.cu",
                           "yolopoint_tpu/ops/pallas_gather.py:31", "serve"),
    "K4": ("warp_image (K4 shapes)", "yolopoint_tpu_torch/ops/csrc/warp.cu",
           "yolopoint_tpu/ops/pallas_warp.py:185", "train"),
    "K5": ("warp_image (K5 shapes)", "yolopoint_tpu_torch/ops/csrc/warp.cu",
           "yolopoint_tpu/ops/pallas_warp.py:47", "train"),
    "K6": ("nms_suppressed_map", "yolopoint_tpu_torch/ops/csrc/nms_keys.cu",
           "yolopoint_tpu/ops/pallas_nms.py:97", "serve_untiled"),
}


GLOBAL_BRANCH = {"nms_tile_keys": "nms_tile_keys_global", "K6": "K6_global"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "yolopoint_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from yolopoint_tpu_torch import set_determinism
    from yolopoint_tpu_torch.ops import _build

    set_determinism()
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    path, compiled = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "compiled": compiled,
          "library": path.name, "sources": [p.name for p in _build.sources()]})

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_shape = {}  # launch-count key -> the kernel's line at the shapes of its path
    path_shapes = {}  # launch-count key -> its lines at the shapes of the other paths

    def record(key, line, path):
        if path == KERNELS[key][3] and key not in main_shape:  # the path's first line
            main_shape[key] = line
        elif path:
            path_shapes.setdefault(key, []).append(dict(line, path=path))

    for check, args, kwargs, path in (
        (check_k1, (16, torch.bfloat16, 40), {}, "serve"),
        (check_k1, (1, torch.bfloat16, 40), {}, None),  # the batch-1 requests of serve
        (check_k1, (8, torch.float32, 40), {}, None),
        (check_k1, (1, torch.float32, 40), {}, "export"),  # the aggregate's NMS
        (check_k1, (1, torch.float32, 40), dict(H=256, W=320), "hpatches"),
        (check_k1, (1, torch.float32, 40), dict(H=288, W=960, r=8), "serve_kitti"),
        (check_k1, (1, torch.bfloat16, 40), dict(H=288, W=960, r=8), None),
        (check_k1, (1, torch.float32, 40), dict(H=320, W=960), "export_kitti"),
        (check_k1, (1, torch.float32, 40), dict(H=480, W=640), "export_coco"),
        (check_k1, (8, torch.float32, 40), dict(H=KITTI_VIEW[0], W=KITTI_VIEW[1]), "fit_kitti"),
        (check_k1, (1, torch.float32, 40), dict(H=352, W=640, r=8), "ros"),  # the launch file's
        (check_k2, (16, 512, 40), {}, "serve"),
        (check_k2, (4, 2048, 20), {}, None),
        (check_k2, (8, 1024, 20), {}, None),  # one tile of the val path's tiled scan
        (check_k2, (1, 1024, 40), {}, "serve_kitti"),
        (check_k2, (1, 1024, 40), {}, "ros"),
        (check_k3, (16, torch.float32, 40), {}, "serve"),
        (check_k3, (1, torch.float32, 40), {}, "serve"),  # the batch-1 requests
        (check_k3, (8, torch.bfloat16, 40), {}, None),
        (check_k3, (16, torch.float32, 40), dict(Hc=32, Wc=40, D=64, N=600), "bootstrap"),
        (check_k3, (1, torch.bfloat16, 40), dict(Hc=32, Wc=40, D=64), None),  # YOLOPoint-n
        (check_k3, (16, torch.float32, 40), dict(D=192), None),  # YOLOPoint-m
        (check_k3, (1, torch.float32, 40), dict(D=192), None),
        (check_k3, (16, torch.bfloat16, 40), dict(D=320), None),  # YOLOPoint-x
        (check_k3, (1, torch.float32, 40), dict(D=320), None),
        (check_k3, (1, torch.float32, 40), dict(Hc=36, Wc=120, N=600), "serve_kitti"),
        (check_k3, (1, torch.float32, 40), dict(Hc=44, Wc=80, N=600), "ros"),
        (check_k3, (16, torch.float32, 40), dict(D=256), "serve_families"),  # SuperPointNet
        (check_k3, (1, torch.float32, 40), dict(Hc=32, Wc=40, D=256), "hpatches_superpoint"),
        (check_k3, (8, torch.float32, 40), dict(Hc=36, Wc=112, N=600), "fit_kitti"),
        (check_k3, (8, torch.float32, 40), dict(D=256), "fit_SuperPointNet"),  # its val batch
    ):
        before = sum(_build.launch_counts.values())
        line = check(gen, *args, **kwargs)
        line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
        emit({"phase": "kernel", "path": path, **line})
        record(line["kernel"], line, path)

    before = sum(_build.launch_counts.values())
    line = check_k3_instantiations(gen)
    emit({"phase": "kernel", **line, "launches": sum(_build.launch_counts.values()) - before})

    for line in check_warps(gen):
        emit({"phase": "kernel", **line})
        record(line["kernel"], line, line.pop("path"))

    before = sum(_build.launch_counts.values())
    val_tiles = check_k2_tiles(record_val_tiles(seed=0))
    val_tiles["launches"] = sum(_build.launch_counts.values()) - before  # recording included
    emit({"phase": "kernel", **val_tiles})

    for B, H, W, dtype, radius, path in ((16, 640, 640, torch.bfloat16, 4, "serve_untiled"),
                                         (16, 640, 640, torch.bfloat16, 3, None),
                                         (1, 256, 320, torch.float32, 4, None),
                                         (2, 101, 94, torch.float32, 7, None)):
        before = sum(_build.launch_counts.values())
        line = check_k6(gen, B, H, W, dtype, radius, 40 if path else 10)
        line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
        emit({"phase": "kernel", "path": path, **line})
        record(line["kernel"], line, path)

    large = {}  # the global branch's launch key -> its lines
    for args in LARGE_RADIUS_INPUTS:
        before = sum(_build.launch_counts.values())
        line = check_large_radius(gen, *args)
        line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
        emit({"phase": "kernel", **line})
        large.setdefault(line["branch"], []).append(line)

    smi = nvidia_smi()
    path_launches = {}  # each path's launches, counted from 0 around its run
    emit(check_reference(seed=0))
    for name, run in (("serve", serve), ("serve_untiled", serve_untiled),
                      ("serve_frame", serve_frame), ("serve_kitti", serve_kitti),
                      ("serve_families", serve_families), ("aot", aot), ("demo", demo_phase),
                      ("demo_kinds", demo_kinds_phase), ("demo_video", demo_video_phase),
                      ("ros", ros_phase)):
        line, path_launches[name] = run(seed=0)
        emit(dict(line, card=smi))
    emit(train_reference(seed=0))
    train_line, path_launches["train"] = train(seed=0)
    emit(dict(train_line, card=smi))
    emit(val_reference(seed=0))
    line, path_launches["val"] = val(seed=0)
    emit(dict(line, card=smi))
    fit_line, path_launches["fit"] = fit(seed=0, train_ms=train_line["ms_per_step_p50"])
    emit(dict(fit_line, card=smi))
    line, path_launches["fit_host"] = fit_host(seed=0, fit_line=fit_line)
    emit(dict(line, card=smi))
    lines, launches, dp_warps = dp_phases(smi)
    for line in lines:
        emit(line)
    path_launches.update(launches)
    dp_kernels = set()
    for img, hom, mode in dp_warps:  # the warps at a rank's shapes, (B / 2, ...)
        before = sum(_build.launch_counts.values())
        line = check_warp_on(img, hom, mode, 10, "recorded")
        line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
        emit({"phase": "kernel", "path": "dp_step", **line})
        record(line["kernel"], line, "dp_step")
        dp_kernels.add(line["kernel"])
    if dp_kernels != {"K4", "K5"}:
        raise AssertionError(f"dp_step: recorded warp inputs of {sorted(dp_kernels)}, "
                             "want K4 and K5")
    line, launches = fit_dp(0, smi, fit_line=fit_line)
    emit(line)
    path_launches.update({path: sum_launches(n) for path, n in launches.items()})
    emit(dryrun_phase(smi))
    lines, launches = fit_families(seed=0)
    for line in lines:
        emit(dict(line, card=smi))
    path_launches.update({f"fit_{name}": n for name, n in launches.items()})
    emit(dict(ransac_phase(seed=0), cpu_count=os.cpu_count()))
    jax_weights_files()  # raises naming what the checkout lacks
    emit(jax_weights_read(smi))
    line, path_launches["jax_weights"], lines = jax_weights_serve()
    emit(dict(line, card=smi))
    for kline in lines:
        emit({"phase": "kernel", "path": "jax_weights", **kline})
        record(kline["kernel"], kline, "jax_weights")
    for run in JAX_RUNS:
        line, path_launches[f"jax_hpatches_{run}"] = jax_weights_hpatches(run, smi)
        emit(line)
    with tempfile.TemporaryDirectory() as tmp:
        root, weights = Path(tmp) / "hpatches", Path(tmp) / "yolopoint_n.pt"
        pairs = write_hpatches_scenes(root, seed=0)
        save_reference_weights(weights, seed=0)
        line, path_launches["hpatches"] = hpatches(0, root, weights, pairs)
        emit(dict(line, card=smi))
        line, path_launches["hpatches_superpoint"] = hpatches(0, root, None, 5, "SuperPointNet")
        emit(dict(line, card=smi))
        emit(hpatches_reference(0, root))
    line, path_launches["export"] = export(seed=0)
    emit(dict(line, card=smi))
    emit(export_reference(seed=0))
    for name in EXPORT_SIZES:
        line, path_launches[f"export_{name}"] = export_family(0, name)
        emit(dict(line, card=smi))
    line, path_launches["export_cli"] = export_cli(seed=0)
    emit(dict(line, card=smi))
    line, path_launches["export_host"] = export_host(seed=0)
    emit(dict(line, card=smi))
    emit(cv_warp_reference(seed=0))
    line, path_launches["bootstrap"], lines = bootstrap_phase(seed=0)
    emit(dict(line, card=smi))
    for kline in lines:
        emit({"phase": "kernel", "path": "bootstrap", **kline})
        record(kline["kernel"], kline, "bootstrap")

    emit(png_phase(seed=0))
    emit(jpeg_phase(seed=0))
    emit(dict(image_formats_phase(seed=0), card=smi))
    emit(dict(video_phase(seed=0), card=smi))
    emit(dict(host_warp_reference(seed=0), card=smi))
    emit(views_host_reference(seed=0))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        tree = write_kitti_tree(root, seed=0)
        emit(views_reference(0, root))
        line, path_launches["fit_kitti"], run, config, tiles = fit_kitti(0, root)
        emit(dict(line, tree=tree, card=smi))
        line, path_launches["detect_kitti"], detect_tiles = detect_kitti(run, config, root)
        emit(dict(line, card=smi))
        line, path_launches["export_kitti_cli"] = export_kitti_cli(0, root)
        emit(dict(line, card=smi))
        coco_tree = write_coco_tree(root, seed=0)
        with no_numpy_decoders():
            line, path_launches["export_coco_cli"] = export_coco_cli(0, root)
            emit(dict(line, card=smi))
            line, path_launches["fit_coco"], run, config, coco_tiles, coco_warps = \
                fit_coco(0, root)
            emit(dict(line, tree=coco_tree, card=smi))
            line, path_launches["detect_coco"], detect_coco_tiles = detect_coco(run, config, root)
            emit(dict(line, card=smi))
            line, path_launches["fit_concat"], concat_warps = fit_concat(0, root)
            emit(dict(line, card=smi))
    for path, recorded in (("fit_kitti", tiles), ("detect_kitti", detect_tiles),
                           ("fit_coco", coco_tiles), ("detect_coco", detect_coco_tiles)):
        before = sum(_build.launch_counts.values())
        line = check_k2_tiles(recorded)
        line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
        emit({"phase": "kernel", "path": path, **line})
        record("greedy_nms_keep", line, path)
        if not line["tiles_with_valid"]:
            raise AssertionError(f"K2 on {path}: every recorded tile is empty")
    # the device warps of the CLI runs (the descriptor loss's cell mask, at
    # the shapes of COCO's letterbox and of the mix's shared canvases)
    for path, recorded in (("fit_coco", coco_warps), ("fit_concat", concat_warps)):
        for img, hom, mode in recorded:
            before = sum(_build.launch_counts.values())
            line = check_warp_on(img, hom, mode, 10, "recorded")
            line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
            emit({"phase": "kernel", "path": path, **line})
            record(line["kernel"], line, path)

    kernels = []
    for key, (name, source, replaces, path) in KERNELS.items():
        k = main_shape[key]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[path][key], "path": path,
            "launches_on_paths": {p: n.get(key, 0) for p, n in path_launches.items()},
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "kernel_ms": k["kernel_ms"],  # the launches alone (CUDA graph)
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            # F.grid_sample for the warp (its nearest mode rounds ties to even),
            # F.grid_sample + F.normalize for K3; no single PyTorch call computes
            # the others
            "library_ms": k.get("library_ms"),
        }
        if key in path_shapes:  # the kernel at the shapes of the other paths
            entry["path_shapes"] = [
                {f: ln.get(f) for f in ("path", "shape", "dtype", "radius", "branch",
                                        "homographies", "max_abs_err", "ms", "kernel_ms",
                                        "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "global_tiles") if f in ln}
                for ln in path_shapes[key]]
        if key == "greedy_nms_keep":
            entry["val_tiles"] = {k2: val_tiles[k2] for k2 in (
                "tiles", "valid", "ms", "kernel_ms", "kernel_ms_all_tiles", "bound_ms")}
        branch = GLOBAL_BRANCH.get(key)
        if branch:  # the large-radius branch: on no path, launched by its checks
            entry["global_branch"] = {
                "key": branch, "launches_on_paths": sum(n.get(branch, 0)
                                                        for n in path_launches.values()),
                "checked": [{f: ln[f] for f in ("shape", "dtype", "radius", "kernel_ms",
                                                 "launches")} for ln in large[branch]]}
        kernels.append(entry)
    emit({"kernels": kernels, "wall_s": time.perf_counter() - t_start,
          "multi_rank_paths": "launches summed over the ranks of one run: dp_step, "
                              "sharded_serve_world2 and fit_dp_host 2 ranks each"})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_cards(phases) -> int:
    """`--cards 4`: the multi-card paths, one NCCL rank a card (`CARDS_PHASES`,
    or the subset `phases`). Builds the kernels once before any rank starts;
    raises where fewer than `CARDS` cards are visible. Prints a line a
    phase, then the `kernels` line (K1-K5 at each rank's recorded inputs,
    launches a rank and summed), every card's name and power limit, and the
    last line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "yolopoint_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository", file=sys.stderr)
        return 2
    unknown = set(phases) - set(CARDS_PHASES)
    if unknown:
        raise ValueError(f"--phases {','.join(phases)}: the mode runs the phases "
                         f"{','.join(CARDS_PHASES)}")
    sys.path.insert(0, str(REPO))
    from yolopoint_tpu_torch import set_determinism
    from yolopoint_tpu_torch.ops import _build

    require_cards()
    set_determinism()
    t_start = time.perf_counter()
    path, compiled = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t_start, "compiled": compiled,
          "library": path.name})
    info = cards_info()
    emit(info)
    smi = info["cards"]
    launches, checks, failed = {}, {}, []

    def guarded(name, fn):
        """Run one phase; a failure is printed and fails the run at its end,
        after the phases that do not depend on it."""
        try:
            fn()
        except Exception:  # noqa: BLE001 (each phase's failure is reported)
            failed.append(name)
            emit({"phase": name, "failed": traceback.format_exc()[-6000:]})

    def session(group):
        logs = []
        ranks = run_ranks("cards:" + ",".join(group), CARDS, "nccl", "cuda",
                          env={**DETERMINISTIC_ENV, **NCCL_ENV}, timeout=CARDS_SESSION_TIMEOUT,
                          logs=logs)
        lines, paths, by_kernel = cards_lines(ranks, smi, logs)
        if "dp_step4" in group:  # the yardstick: one card, the whole 32-row batch
            line, _ = train(seed=0, warmup=2, steps=4)
            torch.cuda.empty_cache()
            lines[0]["one_card"] = {k: line[k] for k in ("batch", "accum", "ms_per_step_p50",
                                                         "ms_per_step_all", "peak_memory_gb")}
        if "dp_reference4" in group:
            cpu = run_ranks("dp_reference", CARDS, "gloo", "cpu")[0]
            lines.append({"phase": "dp_reference4", "model": "YOLOPoint-n", "dtype": "f32",
                          "cards": smi, "input": [DP_REFERENCE["B"], DP_REFERENCE["H"],
                                                  DP_REFERENCE["H"]],
                          "world": CARDS, "batch_rank": DP_REFERENCE["B"] // CARDS,
                          **reference_fields(ranks[0]["reference"], cpu, "dp_reference4")})
        for line in lines:
            emit(line)
        for by_rank in by_kernel.values():
            for line in by_rank:
                emit({"phase": "kernel", **line})
        launches.update(paths)
        checks.update(by_kernel)

    def fit():
        line, fit_launches = fit_dp(0, smi, (CARDS, "nccl"), (CARDS, "nccl"))
        emit(dict(line, phase="fit_dp4"))
        launches.update({k.replace("fit_dp", "fit_dp4", 1): v for k, v in fit_launches.items()})

    if "dryrun4" in phases:
        guarded("dryrun4", lambda: emit(dict(dryrun_phase(smi, ((CARDS, "nccl"),)),
                                             phase="dryrun4")))
    for group in CARDS_SESSIONS:  # each a worker session of its own
        group = [p for p in group if p in phases]
        if group:
            guarded(",".join(group), lambda: session(group))
    if "fit_dp4" in phases:
        guarded("fit_dp4", fit)
    if failed:
        print(f"chip_smoke --cards {CARDS}: failed {failed}", file=sys.stderr)
        return 1

    kernels = []
    for key in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors", "K4", "K5"):
        if key not in checks:
            continue
        name, source, replaces, _ = KERNELS[key]
        path = "dp_step4" if key in ("K4", "K5") else "sharded_serve4"
        by_rank = [counts.get(key, 0) for counts in launches[path]]
        if not all(by_rank):
            raise AssertionError(f"{name}: launches a rank on {path} {by_rank}")
        k = checks[key][0]  # rank 0's check at its largest recorded input
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_rank), "launches_by_rank": by_rank, "path": path,
            "launches_on_paths": {p: [c.get(key, 0) for c in per] for p, per in launches.items()},
            "shape": k["shape"], "max_abs_err": max(c["max_abs_err"] for c in checks[key]),
            "ms": k["ms"], "kernel_ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
            "by_rank": [{f: c[f] for f in ("device", "shape", "max_abs_err", "ms", "kernel_ms")}
                        for c in checks[key]]})
    emit({"kernels": kernels, "wall_s": time.perf_counter() - t_start, "world": CARDS,
          "multi_rank_paths": "launches a rank of each path and their sum"})
    for line in info["name_power"]:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:  # a rank of a data-parallel phase (`run_ranks`)
        sys.exit(worker_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--cards"]:  # the multi-card paths (`main_cards`)
        if sys.argv[2:3] != [str(CARDS)]:
            sys.exit(f"chip_smoke: --cards takes {CARDS}")
        phases = sys.argv[4].split(",") if sys.argv[3:4] == ["--phases"] else CARDS_PHASES
        sys.exit(main_cards(phases))
    if sys.argv[1:2] == ["--bootstrap-chain"]:  # the whole chain (`bootstrap_chain`)
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is available")
        sys.path.insert(0, str(REPO))
        budget = float(sys.argv[3]) if len(sys.argv) > 3 else 1e9
        sys.exit(bootstrap_chain(Path(sys.argv[2]), budget))
    sys.exit(main())
