"""Model zoo: GPT-2, the ResNet family, and the CNN zoo (MLP, CNN,
AlexNet, VGG, MobileNetV2, Xception, U-Net)."""
