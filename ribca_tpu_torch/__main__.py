from ribca_tpu_torch.cli import main

main()
