# Default runtime settings (schema-compatible with the reference's
# configs/_base_/default_runtime.py so OA-DG configs run unchanged).
checkpoint_config = dict(interval=1)
log_config = dict(
    interval=50,
    hooks=[
        dict(type='TextLoggerHook'),
    ])
custom_hooks = [dict(type='NumClassCheckHook')]

dist_params = dict(backend='nccl')  # accepted and ignored: XLA collectives are implicit
log_level = 'INFO'
load_from = None
resume_from = None
workflow = [('train', 1)]

# Disable opencv multithreading inside host-side data workers to avoid
# oversubscribing the cores that feed the device.
opencv_num_threads = 0
mp_start_method = 'fork'
auto_scale_lr = dict(enable=False, base_batch_size=16)
