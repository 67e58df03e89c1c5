from r4w_tpu_torch.cli import main

main()
